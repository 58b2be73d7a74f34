// K2 — GQA flash-attention forward, two kernels chosen by input type.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:87), and adds what the serving path
// needs that the Pallas kernel lacks: a query position offset (prefill into
// a cache at cache_idx > 0) and a valid KV length.
//
// What bounds it on the H100: device-memory bytes at every main-path shape
// (q, the visible K/V rows and the output once: 4*e flops per visible
// (query, key) pair against 4*e bytes per K/V row, with sq <= 192 query
// rows per kv head far under the ~295 flop/byte ridge of bf16), and in
// practice latency: the path's calls move 0.1-8 MB, a few microseconds of
// bytes, so what costs is how long one block's chain of key tiles takes
// and how many SMs the grid keeps busy.
//
// bf16: flash_fwd_wgmma, for Hopper.
//  * Key and value widths are template arguments (EK, EV): (16, 16), (64,
//    64), (128, 128), and (192, 128), the naive form of DeepSeek's MLA
//    (q·k over nope 128 + rope 64, values of 128, n = h, an explicit
//    scale), which is plain attention with values narrower than keys.
//  * Both products on the tensor cores: S = Q·Kᵀ as wgmma m64n64k16 over
//    EK with Q and K in shared memory (K-major), O += P·V as wgmma
//    m64n(EV)k16 with P from registers (the S accumulator rounded to bf16
//    in place: the reference's cast of the unnormalised probabilities to
//    V's dtype) and V from shared memory, MN-major (the descriptor's
//    transpose bit).  One warpgroup owns a 64-row M tile; the online
//    softmax runs on the accumulator fragments in registers, masking
//    before exp.  The O accumulator is EV/2 f32 a thread (64 at EV 128).
//  * The g = h/n query heads of a kv head are packed into the M tile, rows
//    (query position, head of the group), so each K/V tile is read once
//    for all g heads; the Q box of the tensor map is (e, g heads, 64/g
//    positions), which lands in exactly that row order.
//  * K/V tiles of 64 keys arrive by TMA into a ring of 2 (EK >= 128) or 3
//    stages, in the swizzled layout wgmma reads (128-byte swizzle, or 32
//    bytes at e = 16; the tensor map and the descriptors name the same
//    one): a 192-wide Q or K tile is three 128-byte swizzle atoms, a
//    128-wide V two, so at (192, 128) shared memory holds Q 24 KB and two
//    stages of K 24 KB + V 16 KB, 107,544 bytes with the barriers and the
//    alignment.  An mbarrier per stage counts the bytes; the next tiles load
//    while the current one is multiplied.  The tensor maps are encoded in
//    the C entry point over the strided (b, S, n, e) views, so a cache
//    prefix is read in place; cuTensorMapEncodeTiled comes through the
//    runtime's driver entry point, so the library links no -lcuda.
//  * When b·n·⌈sq·g/64⌉ blocks would leave most of the 132 SMs idle (the
//    zamba2 engine: 32 heads, b = 1), the key range is split across blocks
//    (`chunk` keys each, planned by kernels/flash_attention.py::plan); each
//    split writes its partial (O, m, l) in f32 and flash_combine folds
//    them.  Causal blocks stop at the last key any of their rows can see.
// f32: flash_fwd, CUDA-core f32 FMAs over tiles staged in shared memory
// (wgmma has no full-f32 mode, and TF32 would break the 2e-5 tolerance
// the reduced f32 models are held to).
//
// Window mode (window > 0; the hybrid family's sliding-window ring
// cache): key slot j has position kv_positions[j], and the query at qpos =
// q_offset + i sees it iff qpos - window < kpos and kpos <= qpos (causal),
// both in 64 bits (an empty slot holds NEG_POS = -2^30).  The slot order
// is not the position order, so no tile is skipped by the causal edge:
// every slot tile below kv_len is visited, each key masked by its
// position (loaded while S = Q Kᵀ is on the tensor cores), and
// kernels/flash_attention.py::plan splits the whole slot range.
//
// Semantics follow the reference `mha`: scores = q.k · scale in f32 (scale
// 1/sqrt(ek) unless the caller gives one), causal mask q_offset + qpos >=
// kpos, keys kpos >= kv_len masked, the unnormalised probabilities are
// rounded to V's dtype before P.V, f32 accumulation, fully masked rows
// output 0.  q-head hh reads kv head
// hh / (h/n), the (b,sq,n,g,e) grouping of layers._gqa_scores.
//
// LSE output (training): when the caller passes an lse pointer, each
// query row's log-sum-exp of its visible scaled scores, f32 (b, h, sq) in
// natural-log units, is written beside the output (-inf for a row with no
// visible key): flash_fwd's m is already natural, flash_fwd_wgmma's m runs
// in base 2 (exp2f of pre-scaled scores), so there lse = (m + log2 l)·ln 2,
// converted once in the epilogue or in flash_combine.  K2's backward
// (flash_attention_bwd.cu) recomputes P from it.  Serving passes null and
// writes nothing.
//
// MLA mode (flash_mla_wgmma, flash_mla, flash_mla_combine): DeepSeek's
// multi-head latent attention in its absorbed form, the prefill chunk over
// the latent cache (q·k 576, v 512 = the keys' first columns, n = 1, g =
// 128, causal at q_offset, an explicit scale): bf16 runs mla.cuh's wgmma
// loop (flash_mla_wgmma: TMA-fed tiles, causal blocks longest first,
// splits merged inside their cluster), f32 its CUDA-core loop (flash_mla,
// + flash_mla_combine when split), shared with K1's MLA mode.  It has no LSE output and no backward: no
// training path runs a cache.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"
#include "mla.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr float kLn2 = 0.6931471805599453f;

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBQ / kWarps;

// shared memory: Q [kBQ][EK], K [kBK][EK + 1], V [kBK][EV + 1], P
// [kBQ][kBK], alpha and l: 70,144 bytes at (192, 128), 53,760 at (128, 128)
template <int EK, int EV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * EK + kBK * (EK + 1) + kBK * (EV + 1) +
                          kBQ * kBK + 2 * kBQ);
}

template <typename T, int EK, int EV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ kv_positions,
          T* __restrict__ out, float* __restrict__ lse, int sq, int h,
          int n, int kv_len,
          int q_offset, int causal, int window, float scale, long long qsb,
          long long qss, long long qsh, long long ksb, long long kss,
          long long ksn, long long vsb, long long vss, long long vsn) {
  constexpr int kTPC = kThreads / EV;
  constexpr int kRows = kBQ / kTPC;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][EK]
  float* ks = qs + kBQ * EK;               // [kBK][EK + 1]
  float* vs = ks + kBK * (EK + 1);         // [kBK][EV + 1]
  float* ps = vs + kBK * (EV + 1);         // [kBQ][kBK]
  float* alpha_s = ps + kBQ * kBK;         // [kBQ]
  float* l_s = alpha_s + kBQ;              // [kBQ]

  const int q0 = blockIdx.x * kBQ, hh = blockIdx.y, bi = blockIdx.z;
  const int kvh = hh / (h / n);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* qb = q + bi * qsb + hh * qsh;
  const T* kb = k + bi * ksb + kvh * ksn;
  const T* vb = v + bi * vsb + kvh * vsn;

  for (int i = t; i < kBQ * EK; i += kThreads) {
    const int r = i / EK, j = i % EK;
    qs[i] = (q0 + r < sq) ? repro::to_f(qb[(long long)(q0 + r) * qss + j])
                          : 0.f;
  }
  // the last key any row of this block may attend to, plus one (slots in
  // position order only)
  int kend = kv_len;
  if (causal && window <= 0) kend = min(kend, q_offset + min(q0 + kBQ, sq));

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }
  const int col = t % EV, row0 = t / EV;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, kend - k0);
    __syncthreads();
    // one pass over both tiles where they are as wide (as two passes,
    // ptxas spilled at 16 and 64), two where the values are narrower
    if constexpr (EK == EV) {
      for (int i = t; i < kBK * EK; i += kThreads) {
        const int r = i / EK, j = i % EK;
        float kv = 0.f, vv = 0.f;
        if (r < nk) {
          kv = repro::to_f(kb[(long long)(k0 + r) * kss + j]);
          vv = repro::to_f(vb[(long long)(k0 + r) * vss + j]);
        }
        ks[r * (EK + 1) + j] = kv;
        vs[r * (EV + 1) + j] = vv;
      }
    } else {
      for (int i = t; i < kBK * EK; i += kThreads) {
        const int r = i / EK, j = i % EK;
        ks[r * (EK + 1) + j] =
            r < nk ? repro::to_f(kb[(long long)(k0 + r) * kss + j]) : 0.f;
      }
      for (int i = t; i < kBK * EV; i += kThreads) {
        const int r = i / EV, j = i % EV;
        vs[r * (EV + 1) + j] =
            r < nk ? repro::to_f(vb[(long long)(k0 + r) * vss + j]) : 0.f;
      }
    }
    __syncthreads();
    // scores: warp w owns rows w, w+4, ...; lane = key
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = ks + lane * (EK + 1);
#pragma unroll 4
    for (int j = 0; j < EK; ++j) {
      const float kj = krow[j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] += qs[(warp + kWarps * r) * EK + j] * kj;
    }
    const long long kpos =
        (window > 0 && lane < nk) ? kv_positions[k0 + lane] : k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = warp + kWarps * r;
      const long long qpos = (long long)q_offset + q0 + qi;
      const bool valid = lane < nk && (!causal || qpos >= kpos) &&
                         (window <= 0 || kpos > qpos - window);
      const float sv = valid ? s[r] * scale : -CUDART_INF_F;
      const float m_new = fmaxf(m_run[r], repro::warp_max(sv));
      float p = 0.f, alpha = 1.f;
      if (m_new != -CUDART_INF_F) {  // some key of this row is visible
        p = valid ? expf(sv - m_new) : 0.f;
        alpha = expf(m_run[r] - m_new);
      }
      l_run[r] = alpha * l_run[r] + repro::warp_sum(p);
      m_run[r] = m_new;
      ps[qi * kBK + lane] = repro::round_to<T>(p);
      if (lane == 0) alpha_s[qi] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = row0 + kTPC * r;
      float a = acc[r] * alpha_s[qi];
      for (int kk = 0; kk < nk; ++kk)
        a += ps[qi * kBK + kk] * vs[kk * (EV + 1) + col];
      acc[r] = a;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = warp + kWarps * r;
      l_s[qi] = l_run[r];
      if (lse != nullptr && q0 + qi < sq)
        lse[((long long)bi * h + hh) * sq + q0 + qi] =
            l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : -CUDART_INF_F;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + kTPC * r;
    if (q0 + qi < sq) {
      const float l = l_s[qi];
      out[(((long long)bi * sq + q0 + qi) * h + hh) * EV + col] =
          repro::from_f<T>(l > 0.f ? acc[r] / l : 0.f);
    }
  }
}

template <typename T, int EK, int EV>
int launch(const void* q, const void* k, const void* v,
           const int* kv_positions, void* out, float* lse, int b, int sq,
           int h, int n,
           int kv_len, int q_offset, int causal, int window, float scale,
           long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksn, long long vsb, long long vss,
           long long vsn, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<EK, EV>();
  static_assert(smem <= 232448, "shared memory of one block");
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, EK, EV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd<T, EK, EV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_positions, static_cast<T*>(out), lse, sq,
      h, n, kv_len, q_offset, causal, window, scale, qsb, qss, qsh, ksb, kss,
      ksn, vsb, vss, vsn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma with a TMA-fed K/V ring
// ---------------------------------------------------------------------------

constexpr int kM = 64;    // rows of the M tile: (query position, head)
constexpr int kN = 64;    // keys per K/V tile
constexpr int kWG = 128;  // one warpgroup

// a 64-row bf16 tile of width E as TMA writes it (hopper.cuh's layout
// convention): kAtoms swizzle atoms of 64 rows x kSw bytes
template <int E>
struct Swz {
  static constexpr int kAtom = E < 64 ? E : 64;  // elements per swizzle row
  static constexpr int kSw = 2 * kAtom;          // swizzle bytes: 32 or 128
  static constexpr int kAtoms = E / kAtom;
  static constexpr uint64_t kLayout =
      kSw == 128 ? repro::kSwizzle128 : repro::kSwizzle32;
  static constexpr CUtensorMapSwizzle kMap =
      kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int kBytes = kN * E * 2;
  static_assert(kSw == 32 || kSw == 128, "e must be 16, 64, 128 or 192");
  static_assert(E % kAtom == 0, "whole swizzle atoms");
};

// keys EK wide (Q, K), values EV wide (V, O)
template <int EK, int EV>
struct Tile {
  using QK = Swz<EK>;
  using VO = Swz<EV>;
  static constexpr int kPair = QK::kBytes + VO::kBytes;  // a (K, V) stage
  static constexpr int kStages = EK >= 128 ? 2 : 3;
  static constexpr int kAlign = 1024;        // the 128-byte swizzle period
  static constexpr size_t kSmem = kAlign + (size_t)QK::kBytes +
                                  (size_t)kPair * kStages +
                                  8 * (kStages + 1);
  static_assert(kM == kN, "Q and K/V tiles share one row count");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// Shared memory: the Q tile, then kStages (K, V) tile pairs, each tile as
// its swizzle atoms; then the mbarriers (one per stage, one for Q): 107,544
// bytes at (192, 128).  Grid (mtiles * nsplit, n, b): block (mt, split)
// takes query positions [mt*per_tile, +per_tile) of the g heads of kv head
// blockIdx.y, over keys [split*chunk, +chunk).  `scale` multiplies q.k.
template <int EK, int EV>
__global__ void __launch_bounds__(kWG, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const int* __restrict__ kv_positions,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                float* __restrict__ part_o, float* __restrict__ part_ml,
                int b, int sq, int h, int n,
                int kv_len, int q_offset, int causal, int window,
                float scale, int per_tile, int chunk, int nsplit) {
  using TL = Tile<EK, EV>;
  using QK = typename TL::QK;
  using VO = typename TL::VO;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((TL::kAlign - (repro::smem_u32(smem_raw) &
                                             (TL::kAlign - 1))) &
                              (TL::kAlign - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + QK::kBytes +
                                               TL::kPair * TL::kStages);
  uint64_t* qbar = bars + TL::kStages;
  auto k_tile = [&](int s) { return base + QK::kBytes + TL::kPair * s; };
  auto v_tile = [&](int s) { return k_tile(s) + QK::kBytes; };

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int split = blockIdx.x % nsplit, mt = blockIdx.x / nsplit;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int g = h / n;
  const int p0 = mt * per_tile;
  const int rows = per_tile * g;  // rows of the tile that hold a query
  int kend = kv_len;              // one past the last key any row sees
  const bool windowed = window > 0;
  if (causal && !windowed) kend = min(kend, q_offset + min(p0 + per_tile, sq));
  const int k_lo = split * chunk;
  const int k_hi = min(kend, k_lo + chunk);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kN - 1) / kN : 0;

  auto load_kv = [&](int j) {  // one thread: tile j into stage j % kStages
    const int s = j % TL::kStages, key0 = k_lo + j * kN;
    repro::mbar_arrive_expect_tx(&bars[s], TL::kPair);
#pragma unroll
    for (int a = 0; a < QK::kAtoms; ++a)
      repro::tma_load_4d(k_tile(s) + a * kN * QK::kSw, &kmap, &bars[s],
                         a * QK::kAtom, kvh, key0, bi);
#pragma unroll
    for (int a = 0; a < VO::kAtoms; ++a)
      repro::tma_load_4d(v_tile(s) + a * kN * VO::kSw, &vmap, &bars[s],
                         a * VO::kAtom, kvh, key0, bi);
  };
  if (t == 0) {
    for (int s = 0; s <= TL::kStages; ++s) repro::mbar_init(&bars[s], 1);
    repro::mbar_init_fence();
  }
  __syncthreads();
  if (t == 0 && ntiles > 0) {
    repro::mbar_arrive_expect_tx(qbar, rows * EK * 2);
#pragma unroll
    for (int a = 0; a < QK::kAtoms; ++a)
      repro::tma_load_4d(base + a * kM * QK::kSw, &qmap, qbar,
                         a * QK::kAtom, kvh * g, p0, bi);
    for (int j = 0; j < min(TL::kStages, ntiles); ++j) load_kv(j);
  }

  // this thread's two rows of the tile (the wgmma fragment layout: warp w
  // holds rows 16w + lane/4 and + 8) and the keys each may see
  const int r0 = warp * 16 + (lane >> 2);
  int lim[2];
  long long w_lo[2], w_hi[2];  // window mode: visible iff lo < kpos <= hi
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i, pos = p0 + r / g;
    lim[i] = (r < rows && pos < sq)
                 ? (causal && !windowed ? min(k_hi, q_offset + pos + 1)
                                        : k_hi)
                 : INT_MIN;
    w_hi[i] = causal ? (long long)q_offset + pos : LLONG_MAX;
    w_lo[i] = (long long)q_offset + pos - window;
  }
  // scores in base-2 units: s * scale * log2(e), so that exp(s * scale -
  // m) is one exp2 of the scaled difference (m, too, is kept scaled)
  const float scale2 = scale * 1.4426950408889634f;
  float o[EV / 2];  // the 64 x EV accumulator over the warpgroup
#pragma unroll
  for (int i = 0; i < EV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  const uint32_t q_addr = repro::smem_u32(base);
  if (ntiles > 0) repro::mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % TL::kStages;
    // window mode: the positions of this thread's 16 keys of the tile,
    // loaded while the tile lands and S is multiplied
    const int key0 = k_lo + j * kN + 2 * (lane & 3);
    int kpos[16];
    if (windowed) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int key = key0 + 8 * (x >> 1) + (x & 1);
        kpos[x] = key < k_hi ? __ldg(kv_positions + key) : 0;
      }
    }
    repro::mbar_wait(&bars[s], (j / TL::kStages) & 1);
    const uint32_t k_addr = repro::smem_u32(k_tile(s));
    const uint32_t v_addr = repro::smem_u32(v_tile(s));

    // S = Q Kᵀ: EK/16 steps of 16 features, 32 bytes into a swizzle row
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < EK / 16; ++kk) {
      const int a = kk * 16 / QK::kAtom, off = (kk * 16 % QK::kAtom) * 2;
      const uint64_t da = repro::wgmma_desc(
          q_addr + a * kM * QK::kSw + off, 16, 8 * QK::kSw, QK::kLayout);
      const uint64_t db = repro::wgmma_desc(
          k_addr + a * kN * QK::kSw + off, 16, 8 * QK::kSw, QK::kLayout);
      repro::wgmma_m64n64k16_ss(sc, da, db, kk > 0);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(sc);

    // online softmax on the fragments: register 4c + 2i + jj holds row
    // r0 + 8i, key key0 + 8c + jj; a row's 64 keys are spread over the 4
    // lanes of a quad
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int x = 4 * c + 2 * i + jj;
          const long long kp = kpos[2 * c + jj];
          const bool ok = key0 + 8 * c + jj < lim[i] &&
                          (!windowed || (kp > w_lo[i] && kp <= w_hi[i]));
          const float v = ok ? sc[x] * scale2 : -CUDART_INF_F;
          sc[x] = v;
          mx = fmaxf(mx, v);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      // a row with no visible key so far keeps p = 0 and alpha = 0
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[i] = exp2f(m_run[i] - m_use);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int x = 4 * c + 2 * i + jj;
          sc[x] = exp2f(sc[x] - m_use);
          sum += sc[x];
        }
      }
      l_run[i] = l_run[i] * alpha[i] + sum;  // this thread's columns only
    }
#pragma unroll
    for (int c = 0; c < EV / 8; ++c) {
#pragma unroll
      for (int x = 0; x < 4; ++x) o[4 * c + x] *= alpha[x >> 1];
    }
    // P as the A fragments of four k16 steps (16 keys each): the S
    // accumulator layout is the A-fragment layout
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* lo = sc + 8 * kk;
      pa[kk][0] = repro::pack_bf16(lo[0], lo[1]);
      pa[kk][1] = repro::pack_bf16(lo[2], lo[3]);
      pa[kk][2] = repro::pack_bf16(lo[4], lo[5]);
      pa[kk][3] = repro::pack_bf16(lo[6], lo[7]);
    }
    // O += P V: V is (key, EV), MN-major; 16 keys are 16 swizzle rows
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          repro::wgmma_desc(v_addr + kk * 16 * VO::kSw, kN * VO::kSw,
                            8 * VO::kSw, VO::kLayout);
      repro::wgmma_m64nNk16_rs(o, pa[kk], db);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(o);
    __syncthreads();  // every wgmma reading stage s has completed
    if (t == 0 && j + TL::kStages < ntiles) load_kv(j + TL::kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * i, pos = p0 + r / g;
    if (r >= rows || pos >= sq) continue;
    const long long row = ((long long)bi * sq + pos) * h + kvh * g + r % g;
    const int col = 2 * (lane & 3);
    if (nsplit == 1) {
      if (lse != nullptr && (lane & 3) == 0)
        lse[((long long)bi * h + kvh * g + r % g) * sq + pos] =
            l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : -CUDART_INF_F;
      __nv_bfloat16* orow = out + row * EV + col;
#pragma unroll
      for (int c = 0; c < EV / 8; ++c) {
        const float a0 = o[4 * c + 2 * i], a1 = o[4 * c + 2 * i + 1];
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(l > 0.f ? a0 / l : 0.f,
                                  l > 0.f ? a1 / l : 0.f);
      }
    } else {
      const long long slot = (long long)split * b * sq * h + row;
      float* po = part_o + slot * EV + col;
#pragma unroll
      for (int c = 0; c < EV / 8; ++c)
        *reinterpret_cast<float2*>(po + 8 * c) =
            make_float2(o[4 * c + 2 * i], o[4 * c + 2 * i + 1]);
      if ((lane & 3) == 0) {
        part_ml[slot * 2] = m_run[i];
        part_ml[slot * 2 + 1] = l;
      }
    }
  }
}

// Folds the nsplit partial (O, m, l) of flash_fwd_wgmma (m in base-2
// units): a block of kWG threads takes kWG / E output rows (b, position,
// head), thread t column t % E of row t / E (E the value width).  A split
// that saw no key of the row has l = 0 and is skipped; a row with no
// visible key at all outputs 0 (and lse -inf).  With lse, column 0's
// thread writes the row's natural-log LSE at (b, head, position).
template <int E>
__global__ void __launch_bounds__(kWG)
flash_combine(const float* __restrict__ part_o,
              const float* __restrict__ part_ml,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              long long rows_total, int nsplit, int sq, int h) {
  const long long row = (long long)blockIdx.x * (kWG / E) + threadIdx.x / E;
  const int j = threadIdx.x % E;
  if (row >= rows_total) return;
  float m = -CUDART_INF_F;
  for (int s = 0; s < nsplit; ++s) {
    const long long slot = s * rows_total + row;
    if (part_ml[slot * 2 + 1] > 0.f) m = fmaxf(m, part_ml[slot * 2]);
  }
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long slot = s * rows_total + row;
    const float ls = part_ml[slot * 2 + 1];
    if (ls > 0.f) {
      const float w = exp2f(part_ml[slot * 2] - m);
      l += ls * w;
      acc += part_o[slot * E + j] * w;
    }
  }
  out[row * E + j] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
  if (lse != nullptr && j == 0) {
    const long long head = row % h, pos = (row / h) % sq,
                    bi = row / ((long long)h * sq);
    lse[(bi * h + head) * sq + pos] =
        l > 0.f ? (m + log2f(l)) * kLn2 : -CUDART_INF_F;
  }
}

template <int EK, int EV>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const int* kv_positions, void* out, float* lse,
                 void* part_o, void* part_ml, int b, int sq, int h, int n,
                 int sk,
                 int kv_len, int q_offset, int causal, int window,
                 float scale, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksn, long long vsb,
                 long long vss, long long vsn, int per_tile, int chunk,
                 int nsplit, cudaStream_t stream) {
  using TL = Tile<EK, EV>;
  using QK = typename TL::QK;
  using VO = typename TL::VO;
  const int g = h / n;
  if (per_tile < 1 || per_tile * g > kM || nsplit < 1 || chunk < 1 ||
      chunk % kN != 0 || sk < 1)
    return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = repro::make_map_4d(&qm, q, {EK, h, sq, b}, {1, qsh, qss, qsb},
                               QK::kAtom, g, per_tile, QK::kMap);
  if (err == 0)
    err = repro::make_map_4d(&km, k, {EK, n, sk, b}, {1, ksn, kss, ksb},
                             QK::kAtom, 1, kN, QK::kMap);
  if (err == 0)
    err = repro::make_map_4d(&vm, v, {EV, n, sk, b}, {1, vsn, vss, vsb},
                             VO::kAtom, 1, kN, VO::kMap);
  if (err != 0) return err;
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<EK, EV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TL::kSmem);
  if (attr != cudaSuccess) return attr;
  const int mtiles = (sq + per_tile - 1) / per_tile;
  flash_fwd_wgmma<EK, EV><<<dim3(mtiles * nsplit, n, b), kWG, TL::kSmem,
                            stream>>>(
      qm, km, vm, kv_positions, static_cast<__nv_bfloat16*>(out), lse,
      static_cast<float*>(part_o), static_cast<float*>(part_ml), b, sq, h, n,
      kv_len, q_offset, causal, window, scale, per_tile, chunk, nsplit);
  cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess || nsplit == 1) return e2;
  const long long rows_total = (long long)b * sq * h;
  flash_combine<EV><<<(rows_total + kWG / EV - 1) / (kWG / EV), kWG, 0,
                      stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), lse, rows_total, nsplit, sq, h);
  return cudaGetLastError();
}

// MLA mode: mla.cuh's tile loop over a chunk of queries
template <typename T, int EK, int EV>
__global__ void __launch_bounds__(repro_mla::kThreads, 2)
flash_mla(const repro_mla::Args a) {
  extern __shared__ __align__(16) unsigned char mla_smem[];
  repro_mla::attend<T, EK, EV>(a, mla_smem);
}

// MLA mode, bf16 absorbed form: mla.cuh's wgmma tile loop
__global__ void __launch_bounds__(repro_mla::kWgThreads, 1)
flash_mla_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const repro_mla::WgArgs a) {
  extern __shared__ __align__(16) uint8_t mla_wg_smem[];
  repro_mla::attend_wgmma(&qmap, &kmap, a, mla_wg_smem);
}

template <typename T, int EV>
__global__ void __launch_bounds__(256)
flash_mla_combine(const float* part_o, const float* part_ml, T* out,
                  long long rows, int nsplit) {
  repro_mla::combine<T, EV>(part_o, part_ml, out, rows, nsplit);
}

}  // namespace

// q (b,sq,h,ek), k (b,sk,n,ek), v (b,sk,n,ev): unit stride on the last
// axis, element strides for the other axes (a cache prefix view is read in
// place); out (b,sq,h,ev) contiguous in q's dtype.  (ek, ev) is one of
// (16, 16), (64, 64), (128, 128) and (192, 128) (DeepSeek's naive MLA
// form); scale multiplies q.k (flash_attention.py passes 1/sqrt(ek) when
// the caller gives none).  kv_len <= sk keys are visible.  bf16 runs
// flash_fwd_wgmma with the plan (per_tile, chunk, nsplit) of
// flash_attention.py::plan; its strides must be multiples of 8 elements
// and its pointers 16-byte aligned (TMA), and part_o (nsplit,b,sq,h,ev) /
// part_ml (nsplit,b,sq,h,2) are f32 scratch when nsplit > 1.  f32 runs
// flash_fwd and ignores the plan and the scratch.  window > 0 is the
// window mode, with kv_positions (sk,) int32.  lse, if not null, is f32
// (b, h, sq): each row's natural-log LSE (training; serving passes null).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* kv_positions,
    void* out, void* lse, void* part_o, void* part_ml, int dtype, int b,
    int sq, int h, int n, int sk, int ek, int ev, int kv_len, int q_offset,
    int causal, int window, float scale, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksn,
    long long vsb, long long vss, long long vsn, int per_tile, int chunk,
    int nsplit, void* stream) {
  if (h % n != 0 || window < 0 || (window > 0) != (kv_positions != nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto kp = static_cast<const int*>(kv_positions);
  auto ls = static_cast<float*>(lse);
  if (dtype == repro::kBF16) {
#define REPRO_WGMMA(EK, EV)                                                 \
  if (ek == EK && ev == EV)                                                 \
    return launch_wgmma<EK, EV>(q, k, v, kp, out, ls, part_o, part_ml, b,   \
                                sq, h, n, sk, kv_len, q_offset, causal,     \
                                window, scale, qsb, qss, qsh, ksb, kss,     \
                                ksn, vsb, vss, vsn, per_tile, chunk,        \
                                nsplit, st);
    REPRO_WGMMA(16, 16)
    REPRO_WGMMA(64, 64)
    REPRO_WGMMA(128, 128)
    REPRO_WGMMA(192, 128)
#undef REPRO_WGMMA
  } else if (dtype == repro::kF32) {
#define REPRO_FLASH(EK, EV)                                                 \
  if (ek == EK && ev == EV)                                                 \
    return launch<float, EK, EV>(q, k, v, kp, out, ls, b, sq, h, n, kv_len, \
                                 q_offset, causal, window, scale, qsb, qss, \
                                 qsh, ksb, kss, ksn, vsb, vss, vsn, st);
    REPRO_FLASH(16, 16)
    REPRO_FLASH(64, 64)
    REPRO_FLASH(128, 128)
    REPRO_FLASH(192, 128)
#undef REPRO_FLASH
  }
  return cudaErrorInvalidValue;
}

// MLA mode, the absorbed form: q (b,sq,h,576), k (b,sk,n,576), v the view
// of k's first 512 columns (not read: the values come from the K tile),
// unit stride on the last axis and element strides for the others, every
// row 16-byte aligned; out (b,sq,h,512) contiguous in q's dtype.  kv_len
// <= sk keys are visible, query i sits at q_offset + i, the mask is causal
// if asked; scale multiplies q.k (log2(e) is applied here).  bf16 runs
// flash_mla_wgmma (wgmma = 1) with the plan (chunk, nsplit) of
// flash_attention.py::mla_wgmma_plan (nsplit <= 8, one cluster; q and k
// TMA-ready: strides multiples of 16 bytes).  f32 runs flash_mla with
// mla_plan's, and part_o (nsplit,b,sq,h,512) and part_ml (nsplit,b,sq,h,2)
// are its f32 scratch when nsplit > 1.  (DeepSeek's naive form, (192,
// 128), is repro_flash_attention's.)
extern "C" int repro_flash_mla(
    const void* q, const void* k, const void* v, void* out, void* part_o,
    void* part_ml, int dtype, int b, int sq, int h, int n, int sk, int ek,
    int ev, int kv_len, int q_offset, int causal, float scale, int chunk,
    int nsplit, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksn, long long vsb, long long vss,
    long long vsn, int wgmma, void* stream) {
  if (kv_len < 0 || kv_len > sk || q_offset < 0 || ek != 576 || ev != 512)
    return cudaErrorInvalidValue;
  const float scale2 = scale * 1.4426950408889634f;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16 && wgmma) {
    const int seen = q_offset + sq < kv_len ? q_offset + sq : kv_len;
    const int keys = causal ? seen : kv_len;
    if ((long long)chunk * nsplit < keys) return cudaErrorInvalidValue;
    const repro_mla::WgArgs a{static_cast<__nv_bfloat16*>(out), nullptr,
                              sq, h, n, sk, kv_len, q_offset, causal, chunk,
                              nsplit, scale2};
    return repro_mla::launch_wgmma(flash_mla_wgmma, q, k, a, b, qsb, qss,
                                   qsh, ksb, kss, ksn, st);
  }
  if (wgmma || dtype != repro::kF32) return cudaErrorInvalidValue;
  repro_mla::Args a{q, k, nullptr, out, static_cast<float*>(part_o),
                    static_cast<float*>(part_ml), b, sq, h, n, sk, kv_len,
                    q_offset, causal, chunk, nsplit, scale2, qsb, qss, qsh,
                    ksb, kss, ksn};
  return repro_mla::launch<float, 576, 512>(
      flash_mla<float, 576, 512>, flash_mla_combine<float, 512>, a, st);
}
