// The MLA mode of K1 and K2: DeepSeek's multi-head latent attention
// (repro/models/mla.py), whose values are narrower than its keys and
// whose scale is given (1/sqrt(qk_head_dim), not 1/sqrt(e)).
//
// The absorbed form (every cached prefill chunk and decode step) reaches
// it: the 128 query heads of a token attend over one latent row per key,
// keys the 576-wide rows [ckv | krope] of the cache, values their first
// 512 columns, read from the K tile (n = 1, g = 128).  (The naive form,
// the forward without a cache, per-head K/V with q·k 192 wide and v 128,
// is plain GQA attention with n = h: K2's generic route takes it, in
// flash_attention.cu, with its LSE and its backward.)
// K1 (decode_attention.cu) runs one query per row over the first
// lengths[b] keys; K2 (flash_attention.cu) a chunk of sq queries at
// q_offset + i, causal or not, over the first kv_len keys.  Both run the
// two tile loops below: attend_mma (bf16, on the tensor cores:
// decode_mla_mma, flash_mla_mma) and attend (f32 on the CUDA cores:
// decode_mla, flash_mla).
//
// What bounds it on the H100: at the absorbed decode, bytes (a step
// reads each 1152-byte latent row once for all 128 heads: about 1 MB at
// 923 keys, 0.3 us, against 2·128·1088 flops a row); at a prefill chunk,
// operations (the 128 positions x 128 heads of a chunk share each row).
// What the design does:
//  * A block takes rows (query position, head) of one (b, kv head): row
//    r of the g·sq rows is position r / g, head r % g, so at g = 128 a
//    block's rows share one position and one causal key range, and each
//    K row it loads serves all of them.  Keys come in tiles of 32 by
//    cp.async into padded shared rows (16 bytes of pad: consecutive rows
//    land on consecutive 16-byte banks); V is read from the K tile (its
//    first 512 columns), so a latent row is loaded once.
//  * attend (32 rows, 256 threads): thread (sr, sc) computes scores of
//    rows sr, sr + 16 against keys sc, sc + 16, 8 elements a step; the
//    online softmax (base 2, masking before exp) reduces each row over
//    its 16 lanes by shuffles and writes the probabilities, in f32, to
//    shared memory transposed.  P·V: thread (rg, cg) keeps kRM rows x 8
//    columns of the (32, EV) f32 accumulator in registers (8 rows at EV =
//    512), so each V element of a tile is read once by the block.  attend_mma is described where it is defined.
//  * The key range is split across blocks (chunk keys each; the plan is
//    kernels/flash_attention.py::mla_plan) when the blocks would leave
//    the card short of work: the single-token decode has 2 (attend_mma)
//    or 4 (attend) row blocks for 128 heads and takes up to one split a
//    key tile.  Splits write (O, m, l) in f32 and the combine folds them.
// Numerics as `mha`: f32 scores times scale, masked before the row max,
// fully masked rows output 0, f32 sums.  Unlike the other attention
// kernels the probabilities keep about 16 bits in P.V (f32 in attend,
// bf16 hi + lo in attend_mma): deepseek's rows are peaked, so rounding
// the few heavy probabilities to bf16 moves an output by up to a bf16
// step.  The plain version's own rounding of them puts it up to 2e-2
// from the exact output, so chip_smoke holds the kernels to a near-exact
// version (f64 values) as well as to the plain one.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

// Everything here has internal linkage (an unnamed namespace): the K1 and
// K2 libraries each instantiate these templates, and in a process that
// loads both, a template with external linkage resolves to one library's
// copy (a function-local static of it once made one library skip the
// other's shared-memory attribute, and its launches failed).
namespace repro_mla {
namespace {

constexpr int kBM = 32;        // query rows a block: (position, head) pairs
constexpr int kBK = 32;        // keys a tile
constexpr int kThreads = 256;  // 8 warps

struct Args {
  const void* q;        // (b, sq, h, EK), strides qsb, qss, qsh
  const void* k;        // (b, sk, n, EK), strides ksb, kss, ksn
  const int* lengths;   // (b,) keys visible per batch row (K1), or null
  void* out;            // (b, sq, h, EV) contiguous, q's type
  float* part_o;        // (nsplit, b·sq·h, EV) when nsplit > 1
  float* part_ml;       // (nsplit, b·sq·h, 2): m (base 2), l
  int b, sq, h, n, sk, kv_len, q_offset, causal, chunk, nsplit;
  float scale;          // the caller's scale times log2(e)
  long long qsb, qss, qsh, ksb, kss, ksn;   // the values: k's first EV
};

// V is the K tile's first EV columns
template <typename T, int EK, int EV>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);    // elements in 16 bytes
  static constexpr int kQS = EK + kVec;          // padded row stride
  static constexpr int kPS = kBM + 4;            // P is [kBK][kPS] f32
  static constexpr size_t kQBytes = (size_t)kBM * kQS * sizeof(T);
  static constexpr size_t kKBytes = (size_t)kBK * kQS * sizeof(T);
  static constexpr size_t kPBytes = (size_t)kBK * kPS * sizeof(float);
  static constexpr size_t kSmem =
      kQBytes + kKBytes + kPBytes + 3 * kBM * sizeof(float);
  // P·V: thread (rg, cg) owns rows [rg·kRM, +kRM) x columns [cg·8, +8)
  static constexpr int kCG = EV / 8;
  static constexpr int kRG = kThreads / kCG;
  static constexpr int kRM = kBM / kRG;
  static_assert(EK % 8 == 0 && EV % 8 == 0 && EV <= EK, "widths");
  static_assert(kThreads % kCG == 0 && kBM % kRG == 0, "value width");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// 8 elements of T at a 16-byte-aligned shared address, as floats
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 16 bytes global -> shared, asynchronously; `ok` false writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows [0, nrows) of a tile of W-wide rows: row r from src(r), the rest
// zero
template <typename T, int W, typename Src>
__device__ __forceinline__ void load_tile(T* dst, int stride, int rows,
                                          int nrows, Src src) {
  constexpr int kC = W * (int)sizeof(T) / 16;     // 16-byte chunks a row
  constexpr int kVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    const bool ok = r < nrows;
    cp16(dst + r * stride + c * kVec, ok ? src(r) + c * kVec : src(0), ok);
  }
}

// Grid (nsplit, ⌈g·sq / kBM⌉, b·n), kThreads threads, Layout::kSmem bytes
// of dynamic shared memory.
template <typename T, int EK, int EV>
__device__ __forceinline__ void attend(const Args& a, unsigned char* smem) {
  using Lay = Layout<T, EK, EV>;
  constexpr int kQS = Lay::kQS, kPS = Lay::kPS;
  constexpr int kRM = Lay::kRM;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + Lay::kQBytes);
  const T* sV = sK;
  float* sP = reinterpret_cast<float*>(smem + Lay::kQBytes + Lay::kKBytes);
  float* sAlpha = sP + kBK * kPS;
  float* sM = sAlpha + kBM;
  float* sL = sM + kBM;

  const int g = a.h / a.n, rows = a.sq * g;
  const int split = blockIdx.x, row0 = blockIdx.y * kBM;
  const int bi = blockIdx.z / a.n, kvh = blockIdx.z % a.n;
  const int t = threadIdx.x;
  const T* q = static_cast<const T*>(a.q) + bi * a.qsb;
  const T* kb = static_cast<const T*>(a.k) + bi * a.ksb + kvh * a.ksn;

  // the keys the block's rows may see, and this split's share of them
  const int len = a.lengths != nullptr ? max(0, min(a.lengths[bi], a.sk))
                                       : a.kv_len;
  const int last = min(row0 + kBM, rows) - 1;
  const int kend = a.causal ? min(len, a.q_offset + last / g + 1) : len;
  const int kbeg = split * a.chunk;
  const int kstop = min(kbeg + a.chunk, kend);

  load_tile<T, EK>(sQ, kQS, kBM, min(kBM, rows - row0), [&](int r) {
    const int row = row0 + r;
    return q + (row / g) * a.qss + (kvh * g + row % g) * a.qsh;
  });

  // scores: thread (sr, sc) takes rows sr, sr + 16 and keys sc, sc + 16
  const int sr = t >> 4, sc = t & 15;
  bool rvalid[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + sr + 16 * i;
    rvalid[i] = row < rows;
    qpos[i] = a.q_offset + row / g;
  }
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  // P·V: thread (rg, cg)
  const int cg = t % Lay::kCG, rg = t / Lay::kCG;
  float acc[kRM][8];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int k0 = kbeg; k0 < kstop; k0 += kBK) {
    const int nk = min(kBK, kstop - k0);
    __syncthreads();  // the last tile's K, V and P are read
    load_tile<T, EK>(sK, kQS, kBK, nk, [&](int r) {
      return kb + (long long)(k0 + r) * a.kss;
    });
    cp_wait();
    __syncthreads();

    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int e = 0; e < EK; e += 8) {
      float q0[8], q1[8], c0[8], c1[8];
      load8(sQ + sr * kQS + e, q0);
      load8(sQ + (sr + 16) * kQS + e, q1);
      load8(sK + sc * kQS + e, c0);
      load8(sK + (sc + 16) * kQS + e, c1);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        s[0][0] = fmaf(q0[x], c0[x], s[0][0]);
        s[0][1] = fmaf(q0[x], c1[x], s[0][1]);
        s[1][0] = fmaf(q1[x], c0[x], s[1][0]);
        s[1][1] = fmaf(q1[x], c1[x], s[1][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + sc + 16 * j;
        const bool ok =
            rvalid[i] && key < kstop && (!a.causal || key <= qpos[i]);
        s[i][j] = ok ? s[i][j] * a.scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      // no visible key so far: p = 0 and alpha = 0, never inf - inf
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m_run[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        sum += p;
        sP[(sc + 16 * j) * kPS + sr + 16 * i] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      if (sc == 0) sAlpha[sr + 16 * i] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const float al = sAlpha[rg * kRM + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= al;
    }
    for (int j = 0; j < nk; ++j) {
      float vf[8], p[kRM];
      load8(sV + j * kQS + cg * 8, vf);
#pragma unroll
      for (int r = 0; r < kRM; ++r) p[r] = sP[j * kPS + rg * kRM + r];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(p[r], vf[c], acc[r][c]);
    }
  }
  cp_wait();  // the Q tile, where the split had no key to wait on it
  if (sc == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sM[sr + 16 * i] = m_run[i];
      sL[sr + 16 * i] = l_run[i];
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int lr = rg * kRM + r, row = row0 + lr;
    if (row >= rows) continue;
    const long long orow =
        ((long long)bi * a.sq + row / g) * a.h + kvh * g + row % g;
    const float l = sL[lr];
    if (a.nsplit == 1) {
      // a row with no visible key outputs 0, as the reference does
      T* o = static_cast<T*>(a.out) + orow * EV + cg * 8;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        o[c] = repro::from_f<T>(l > 0.f ? acc[r][c] / l : 0.f);
    } else {
      const long long slot =
          (long long)split * a.b * a.sq * a.h + orow;
      float* po = a.part_o + slot * EV + cg * 8;
#pragma unroll
      for (int c = 0; c < 8; ++c) po[c] = acc[r][c];
      if (cg == 0) {
        a.part_ml[slot * 2] = sM[lr];
        a.part_ml[slot * 2 + 1] = l;
      }
    }
  }
}

// Folds the nsplit partial (O, m, l): thread i writes output element i of
// the (rows, EV) output; a split that saw no key of the row (l = 0) is
// skipped, a row with no visible key at all outputs 0.
template <typename T, int EV>
__device__ __forceinline__ void combine(const float* __restrict__ part_o,
                                        const float* __restrict__ part_ml,
                                        T* __restrict__ out, long long rows,
                                        int nsplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * EV) return;
  const long long row = i / EV;
  float m = -CUDART_INF_F;
  for (int s = 0; s < nsplit; ++s) {
    const long long slot = s * rows + row;
    if (part_ml[slot * 2 + 1] > 0.f) m = fmaxf(m, part_ml[slot * 2]);
  }
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long slot = s * rows + row;
    const float ls = part_ml[slot * 2 + 1];
    if (ls > 0.f) {
      const float w = exp2f(part_ml[slot * 2] - m);
      l += ls * w;
      acc += part_o[s * rows * EV + i] * w;
    }
  }
  out[i] = repro::from_f<T>(l > 0.f ? acc / l : 0.f);
}

// ---------------------------------------------------------------------------
// The absorbed form in bf16 on the tensor cores (K1's decode steps, K2's
// prefill chunks)
// ---------------------------------------------------------------------------
//
// attend_mma: q·k 576, values the keys' first 512 columns, bf16.  A block
// of 8 warps takes 64 rows (position, head): warp w computes S = Q Kᵀ for
// the 16 rows of row group w % 4 over each 32-key tile with mma.sync
// m16n8k16 (Q and K by ldmatrix from padded shared rows), runs the online
// softmax on the accumulator fragments, and accumulates P·V into 16 rows
// x the 256 value columns of half w / 4 (V by ldmatrix.trans from the K
// tile).  The two halves of a row group compute the same S: that costs
// 576 of every 1664 multiply-adds, where splitting S across them would
// cost a shared-memory exchange of the row max each tile.  P enters the
// second product as bf16 hi + lo (two mma.sync), so the probabilities
// keep about 16 bits, as the CUDA-core loop's f32 ones (see Numerics).
// K tiles are double-buffered by cp.async; Q stays in shared memory.
constexpr int kMmaRows = 64;
constexpr int kMmaKeys = 32;
constexpr int kMmaEK = 576, kMmaEV = 512, kMmaHalf = kMmaEV / 2;
constexpr int kMmaQS = kMmaEK + 8;     // padded row stride (elements)
constexpr size_t kMmaQBytes = (size_t)kMmaRows * kMmaQS * 2;
constexpr size_t kMmaKBytes = (size_t)kMmaKeys * kMmaQS * 2;
constexpr size_t kMmaSmem = kMmaQBytes + 2 * kMmaKBytes;
static_assert(kThreads == 256, "attend_mma's 8 warps");

// ldmatrix, mma.sync and cp.async groups: hopper.cuh's
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;

// (x, y) = hi + lo, each a bf16 pair with x in the low half
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Grid (nsplit, ⌈g·sq / kMmaRows⌉, b·n), kThreads threads, kMmaSmem bytes
// of dynamic shared memory.
__device__ __forceinline__ void attend_mma(const Args& a,
                                           unsigned char* smem) {
  using T = __nv_bfloat16;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK0 = reinterpret_cast<T*>(smem + kMmaQBytes);
  const int g = a.h / a.n, rows = a.sq * g;
  const int split = blockIdx.x, row0 = blockIdx.y * kMmaRows;
  const int bi = blockIdx.z / a.n, kvh = blockIdx.z % a.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp & 3, hf = warp >> 2;       // row group, value half
  const int gq = lane >> 2, tq = lane & 3;       // mma group, its thread
  const T* q = static_cast<const T*>(a.q) + bi * a.qsb;
  const T* kb = static_cast<const T*>(a.k) + bi * a.ksb + kvh * a.ksn;

  const int len = a.lengths != nullptr ? max(0, min(a.lengths[bi], a.sk))
                                       : a.kv_len;
  const int last = min(row0 + kMmaRows, rows) - 1;
  const int kend = a.causal ? min(len, a.q_offset + last / g + 1) : len;
  const int kbeg = split * a.chunk;
  const int kstop = min(kbeg + a.chunk, kend);
  const int ntiles =
      kstop > kbeg ? (kstop - kbeg + kMmaKeys - 1) / kMmaKeys : 0;

  load_tile<T, kMmaEK>(sQ, kMmaQS, kMmaRows, min(kMmaRows, rows - row0),
                       [&](int r) {
                         const int row = row0 + r;
                         return q + (row / g) * a.qss +
                                (kvh * g + row % g) * a.qsh;
                       });
  auto load_keys = [&](int tile) {
    const int k0 = kbeg + tile * kMmaKeys;
    load_tile<T, kMmaEK>(sK0 + (tile & 1) * kMmaKeys * kMmaQS, kMmaQS,
                         kMmaKeys, min(kMmaKeys, kstop - k0), [&](int r) {
                           return kb + (long long)(k0 + r) * a.kss;
                         });
  };
  if (ntiles > 0) load_keys(0);
  cp_async_commit();

  // this thread's rows (block-local 16·rg + gq and + 8)
  bool rvalid[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * rg + gq + 8 * i;
    rvalid[i] = row < rows;
    qpos[i] = a.q_offset + row / g;
  }
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  float o[kMmaHalf / 8][4];
#pragma unroll
  for (int n = 0; n < kMmaHalf / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // lane's ldmatrix rows: matrix mi = lane / 8, row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  const T* qrow = sQ + (16 * rg + (mi & 1) * 8 + mr) * kMmaQS + (mi >> 1) * 8;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      load_keys(tile + 1);   // the other buffer, freed by the last sync
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = sK0 + (tile & 1) * kMmaKeys * kMmaQS;
    const int k0 = kbeg + tile * kMmaKeys;

    // S = Q Kᵀ: 16 rows x 32 keys (4 n-tiles of 8)
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const T* krow = sK + ((mi >> 1) * 8 + mr) * kMmaQS + (mi & 1) * 8;
#pragma unroll 4
    for (int kk = 0; kk < kMmaEK / 16; ++kk) {
      uint32_t af[4], b01[4], b23[4];
      ldsm_x4(af, qrow + 16 * kk);
      ldsm_x4(b01, krow + 16 * kk);
      ldsm_x4(b23, krow + 16 * kMmaQS + 16 * kk);
      mma_bf16(s[0], af, b01[0], b01[1]);
      mma_bf16(s[1], af, b01[2], b01[3]);
      mma_bf16(s[2], af, b23[0], b23[1]);
      mma_bf16(s[3], af, b23[2], b23[3]);
    }

    // online softmax on the fragments: s[j][e] is row gq + 8·(e / 2), key
    // k0 + 8·j + 2·tq + e % 2; a row's 32 keys lie on its 4 lanes
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + 8 * j + 2 * tq + (e & 1);
        const bool ok =
            rvalid[i] && key < kstop && (!a.causal || key <= qpos[i]);
        s[j][e] = ok ? s[j][e] * a.scale : -CUDART_INF_F;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      mu[i] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[i] = exp2f(m_run[i] - mu[i]);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mu[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < kMmaHalf / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P as A fragments of the two 16-key steps, hi + lo
    uint32_t phi[2][4], plo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], phi[kk][0], plo[kk][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], phi[kk][1], plo[kk][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], phi[kk][2],
                 plo[kk][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], phi[kk][3],
                 plo[kk][3]);
    }
    // O += P V over this half's 256 columns (V: the tile's first 512)
    const T* vrow = sK + ((mi & 1) * 8 + mr) * kMmaQS + kMmaHalf * hf +
                    (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int np = 0; np < kMmaHalf / 16; ++np) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vrow + 16 * kk * kMmaQS + 16 * np);
        mma_bf16(o[2 * np], phi[kk], vf[0], vf[1]);
        mma_bf16(o[2 * np], plo[kk], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], phi[kk], vf[2], vf[3]);
        mma_bf16(o[2 * np + 1], plo[kk], vf[2], vf[3]);
      }
    __syncthreads();  // every warp is done with this K buffer
  }
  cp_async_wait<0>();  // the Q tile, where the split had no key

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * rg + gq + 8 * i;
    if (row >= rows) continue;
    const long long orow =
        ((long long)bi * a.sq + row / g) * a.h + kvh * g + row % g;
    const float l = l_run[i];
    if (a.nsplit == 1) {
      // a row with no visible key outputs 0, as the reference does
      T* op = static_cast<T*>(a.out) + orow * kMmaEV + kMmaHalf * hf +
              2 * tq;
#pragma unroll
      for (int n = 0; n < kMmaHalf / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
            __floats2bfloat162_rn(l > 0.f ? o[n][2 * i] / l : 0.f,
                                  l > 0.f ? o[n][2 * i + 1] / l : 0.f);
    } else {
      const long long slot = (long long)split * a.b * a.sq * a.h + orow;
      float* po = a.part_o + slot * kMmaEV + kMmaHalf * hf + 2 * tq;
#pragma unroll
      for (int n = 0; n < kMmaHalf / 8; ++n)
        *reinterpret_cast<float2*>(po + 8 * n) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (hf == 0 && tq == 0) {
        a.part_ml[slot * 2] = m_run[i];
        a.part_ml[slot * 2 + 1] = l;
      }
    }
  }
}

using AttendFn = void (*)(Args);
template <typename T>
using CombineFn = void (*)(const float*, const float*, T*, long long, int);

// One MLA call: the tile kernel (kernel_rows rows a block, smem bytes of
// dynamic shared memory), then, for a split key range, the combine.
// Returns cudaGetLastError() of the launches.
template <typename T, int EV>
int launch_rows(AttendFn attend_fn, CombineFn<T> combine_fn, const Args& a,
                int kernel_rows, size_t smem, cudaStream_t stream) {
  if (a.n < 1 || a.h % a.n != 0 || a.nsplit < 1 || a.chunk < 1 ||
      a.chunk % kBK != 0 || a.sq < 1 || a.sk < 1 ||
      (a.nsplit > 1 && (a.part_o == nullptr || a.part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      attend_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int mtiles = (a.sq * (a.h / a.n) + kernel_rows - 1) / kernel_rows;
  attend_fn<<<dim3(a.nsplit, mtiles, a.b * a.n), kThreads, smem,
              stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long rows = (long long)a.b * a.sq * a.h;
  combine_fn<<<(unsigned)((rows * EV + 255) / 256), 256, 0, stream>>>(
      a.part_o, a.part_ml, static_cast<T*>(a.out), rows, a.nsplit);
  return cudaGetLastError();
}

template <typename T, int EK, int EV>
int launch(AttendFn attend_fn, CombineFn<T> combine_fn, const Args& a,
           cudaStream_t stream) {
  return launch_rows<T, EV>(attend_fn, combine_fn, a, kBM,
                            Layout<T, EK, EV>::kSmem, stream);
}

}  // namespace
}  // namespace repro_mla
