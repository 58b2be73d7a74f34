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
// two tile loops below: attend_wgmma (bf16 on Hopper's wgmma and TMA:
// decode_mla_wgmma, flash_mla_wgmma) and attend (f32 on the CUDA cores:
// decode_mla, flash_mla).
//
// What bounds it on the H100: at the absorbed decode, bytes (a step
// reads each 1152-byte latent row once for all 128 heads: about 1 MB at
// 923 keys, 0.3 us, against 2·128·1088 flops a row); at a prefill chunk,
// operations (the 128 positions x 128 heads of a chunk share each row).
// Both loops give a block rows (query position, head) of one (b, kv
// head): at g = 128 a block's rows share one position and one causal key
// range, and each K row it loads serves all of them; V is read from the K
// tile (its first 512 columns), so a latent row is loaded once.
// attend_wgmma is described where it is defined.  attend (f32):
//  * 32 rows, 256 threads; keys in tiles of 32 by cp.async into padded
//    shared rows (16 bytes of pad: consecutive rows land on consecutive
//    16-byte banks).  Thread (sr, sc) computes scores of rows sr, sr + 16
//    against keys sc, sc + 16, 8 elements a step; the online softmax
//    (base 2, masking before exp) reduces each row over its 16 lanes by
//    shuffles and writes the probabilities, in f32, to shared memory
//    transposed.  P·V: thread (rg, cg) keeps kRM rows x 8 columns of the
//    (32, EV) f32 accumulator in registers (8 rows at EV = 512), so each V
//    element of a tile is read once by the block.
//  * The key range is split across blocks (chunk keys each; the plan is
//    kernels/flash_attention.py::mla_plan) when the blocks would leave
//    the card short of work: the single-token decode has 4 row blocks for
//    128 heads and takes up to one split a key tile.  Splits write (O, m,
//    l) in f32 and the combine folds them.
// Numerics as `mha`: f32 scores times scale, masked before the row max,
// fully masked rows output 0, f32 sums.  Unlike the other attention
// kernels the probabilities keep about 16 bits in P.V (f32 in attend,
// bf16 hi + lo in attend_wgmma): deepseek's rows are peaked, so rounding
// the few heavy probabilities to bf16 moves an output by up to a bf16
// step.  The plain version's own rounding of them puts it up to 2e-2
// from the exact output, so chip_smoke holds the kernels to a near-exact
// version (f64 values) as well as to the plain one.
#pragma once

#include <cooperative_groups.h>

#include <climits>
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
// The absorbed form in bf16 on Hopper (K1's decode steps, K2's prefill
// chunks): wgmma, TMA, a producer warp, splits merged inside the cluster
// ---------------------------------------------------------------------------
//
// attend_wgmma: q·k 576, values the keys' first 512 columns, bf16.  A block
// of kWgThreads threads takes 64 rows (position, head) of one (b, kv head)
// over its split of the key range.
//  * The first warp of warpgroup 1 is the producer: its first lane brings
//    the 64 x 576 Q tile, then the 32-key K tiles into a ring of kWgStages
//    stages, by TMA in the 128-byte swizzle (nine atoms of 64 columns
//    each).  A stage has a "full" mbarrier that counts its bytes and an
//    "empty" one that all 256 threads arrive on when they are done with
//    it; the producer refills a stage as warpgroup 1 releases it, three
//    tiles ahead.  No warp is set aside for it: with a 9th warp ptxas
//    held a thread to 168 registers, and with a third warpgroup handing
//    its registers over (setmaxnreg) the accumulators still spilled; the
//    spills made ptxas serialise every wgmma (measured).  At 256 threads
//    a thread may hold 255, and uses 218.
//  * Warpgroup 0 computes S = Q Kᵀ (64 x 32: wgmma m64n32k16 over the 576
//    columns, both operands in shared memory), masks it, runs the online
//    softmax on the accumulator fragments and splits P into bf16 hi + lo.
//    It hands both halves, with each row's rescale factor, to warpgroup 1
//    as a record of kWgRec words a thread in shared memory.  The two
//    warpgroups hold their fragments in one layout, so thread t of one
//    reads what thread t of the other wrote.  Each multiply-add of S is
//    done once.
//  * Each warpgroup owns 256 of the 512 value columns: O += P_hi·V +
//    P_lo·V by wgmma m64n128k16, P from registers, V (the K tile's first
//    512 columns, MN-major) from shared memory.  Warpgroup 0 issues its
//    P·V and the next tile's S back to back and waits once for both, so
//    the tensor cores run one warpgroup's products while the other does
//    its softmax or reads its record.  (Two orders that would hide the
//    softmax behind S made ptxas serialise every wgmma: S of the next tile
//    issued before the softmax into a second accumulator, and S issued in
//    one batch ahead of the P·V.)
//  * Two named barriers pass the record: P_FULL (warpgroup 0 arrives,
//    warpgroup 1 waits) and P_FREE (the reverse).
//  * Splits of the key range (at most kWgMaxSplit) run as one thread-block
//    cluster.  After the loop and a cluster barrier, each block stores its
//    (O, m, l) rows in f32 into the shared memory of the rows' owners,
//    over the Q and K tiles (row r belongs to block r % nsplit); after a
//    second barrier each owner folds its rows, in split order, and writes
//    them.  No partial goes through device memory and no second kernel
//    runs; the fold's order is fixed, so two runs give equal bits.
//  * Causal blocks (K2) are issued longest first: row tile y of the grid
//    takes the tile gridDim.y - 1 - y, whose positions see the most keys.
//  * A block with one split writes its output through shared memory, 16
//    contiguous bytes a thread (a fragment's own stores would be 4).
// What bounds it: at the decode, latency (a split's chain of tiles, the
// cluster's merge, the launch); at a prefill chunk, the tensor cores (S,
// and P·V twice for hi and lo: 576 + 2·512 multiply-adds a pair) and the
// L2 traffic of 132 blocks each streaming the whole key range.
constexpr int kWgRows = 64;                 // rows of a block: one M tile
constexpr int kWgKeys = 32;                 // keys of a K tile
constexpr int kWgStages = 4;                // K tiles in flight
constexpr int kWgEK = 576, kWgEV = 512, kWgHalf = kWgEV / 2;
constexpr int kWgAtom = 64;                 // columns of a 128-byte row
constexpr int kWgAtoms = kWgEK / kWgAtom;   // 9
constexpr int kWgThreads = 256;             // two warpgroups
constexpr int kWgProducer = 128;            // the thread that issues TMA
constexpr int kWgMaxSplit = 8;              // the portable cluster size
constexpr int kWgQAtom = kWgRows * 128;     // bytes of a Q atom
constexpr int kWgKAtom = kWgKeys * 128;     // bytes of a K atom
constexpr int kWgQBytes = kWgAtoms * kWgQAtom;   // 73,728
constexpr int kWgKBytes = kWgAtoms * kWgKAtom;   // 36,864
constexpr int kWgRec = 18;                  // words of a thread's record
constexpr int kWgRecBytes = kWgRec * 128 * 4;    // 9,216
constexpr int kWgAlign = 1024;              // the 128-byte swizzle period
constexpr size_t kWgSmem = kWgAlign + kWgQBytes + kWgStages * kWgKBytes +
                           kWgRecBytes + 8 * (2 * kWgStages + 1);
constexpr int kWgOStride = kWgEV + 8;       // an f32 row of the merge
constexpr int kWgSlots = 72;                // its rows: >= 64 + 8 - 1
constexpr int kWgStageRow = kWgEV + 8;      // a bf16 row of the output
constexpr int kBarPFull = 1, kBarPFree = 2;  // named barriers (0: a sync)
static_assert(kWgSmem <= 232448, "shared memory of one block");
static_assert(kWgSlots >= kWgRows + kWgMaxSplit - 1 &&
                  kWgSlots * (kWgOStride * 4 + 8) +
                          kWgRows * kWgMaxSplit * 4 <=
                      kWgQBytes + kWgStages * kWgKBytes,
              "the merge's (O, m, l) slots and weights over Q and K");

struct WgArgs {
  __nv_bfloat16* out;   // (b, sq, h, 512) contiguous
  const int* lengths;   // (b,) keys visible per batch row (K1), or null
  int sq, h, n, sk, kv_len, q_offset, causal, chunk, nsplit;
  float scale;          // the caller's scale times log2(e)
};

// A block's rows: gb heads of a group of g (from head h0) at each of pb
// positions (from p0); a group of more than 64 heads takes ⌈g/64⌉ blocks
// a position.  kernels/flash_attention.py::mla_row_tiles mirrors it.
struct WgRows {
  int gb, pb, parts;
  __host__ __device__ explicit WgRows(int g)
      : gb(g < kWgRows ? g : kWgRows), pb(g < kWgRows ? kWgRows / g : 1),
        parts(g < kWgRows ? 1 : (g + kWgRows - 1) / kWgRows) {}
  __host__ __device__ int tiles(int sq) const {
    return parts * ((sq + pb - 1) / pb);
  }
};

// (x, y) = hi + lo, each a bf16 pair with x in the low half
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// O (this warpgroup's 256 columns, two m64n128 accumulators) = O·alpha +
// P_hi·V + P_lo·V over one K tile at k_addr, V being half `half` of the
// tile's first 512 columns; issued and committed, not waited for
__device__ __forceinline__ void wg_pv(float (&o)[2][64],
                                      uint32_t (&ph)[2][4],
                                      uint32_t (&pl)[2][4],
                                      const float (&alpha)[2],
                                      uint32_t k_addr, int half) {
#pragma unroll
  for (int sub = 0; sub < 2; ++sub)
#pragma unroll
    for (int x = 0; x < 64; ++x) o[sub][x] *= alpha[(x >> 1) & 1];
  repro::fence_regs(o[0]);
  repro::fence_regs(o[1]);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    repro::fence_regs(ph[kk]);
    repro::fence_regs(pl[kk]);
  }
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      // 16 keys (rows 16kk of every atom) x 128 columns (two atoms)
      const uint64_t dv = repro::wgmma_desc(
          k_addr + (4 * half + 2 * sub) * kWgKAtom + kk * 16 * 128,
          kWgKAtom, 8 * 128, repro::kSwizzle128);
      repro::wgmma_m64nNk16_rs(o[sub], ph[kk], dv);
      repro::wgmma_m64nNk16_rs(o[sub], pl[kk], dv);
    }
  repro::wgmma_commit();
  repro::fence_regs(o[0]);
  repro::fence_regs(o[1]);
}

// Grid (nsplit, WgRows(g).tiles(sq), b·n), clusters of (nsplit, 1, 1),
// kWgThreads threads, kWgSmem bytes of dynamic shared memory.  qmap: q as
// (576, h, sq, b), box (64, gb, pb); kmap: k as (576, n, sk, b), box (64,
// 1, kWgKeys).
__device__ __forceinline__ void attend_wgmma(const CUtensorMap* qmap,
                                             const CUtensorMap* kmap,
                                             const WgArgs& a,
                                             uint8_t* smem_raw) {
  uint8_t* base = smem_raw + ((kWgAlign - (repro::smem_u32(smem_raw) &
                                           (kWgAlign - 1))) &
                              (kWgAlign - 1));
  uint8_t* sK = base + kWgQBytes;
  uint32_t* rec = reinterpret_cast<uint32_t*>(sK + kWgStages * kWgKBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(rec + kWgRec * 128);
  uint64_t* empty = full + kWgStages;
  uint64_t* qbar = empty + kWgStages;
  if (repro::cluster_nctarank() != (uint32_t)a.nsplit) __trap();  // the planned cluster

  const int t = threadIdx.x, lane = t & 31;
  const int g = a.h / a.n;
  const WgRows rt(g);
  const int split = blockIdx.x;
  const int mt = a.causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
  const int bi = blockIdx.z / a.n, kvh = blockIdx.z % a.n;
  const int p0 = (mt / rt.parts) * rt.pb, h0 = (mt % rt.parts) * rt.gb;
  // row r of the tile: position p0 + r / gb, head h0 + r % gb of the group
  auto row_ok = [&](int r) {
    return r < rt.gb * rt.pb && h0 + r % rt.gb < g && p0 + r / rt.gb < a.sq;
  };

  if (t == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], kWgThreads);
    }
    repro::mbar_init(qbar, 1);
    repro::mbar_init_fence();
  }
  __syncthreads();
  if (t == kWgProducer) {  // Q goes out before lengths[b] arrives
    repro::mbar_arrive_expect_tx(qbar, kWgAtoms * 128 * rt.gb * rt.pb);
#pragma unroll
    for (int at = 0; at < kWgAtoms; ++at)
      repro::tma_load_4d(base + at * kWgQAtom, qmap, qbar, at * kWgAtom,
                         kvh * g + h0, p0, bi);
  }

  // the keys the block's rows may see, and this split's share of them
  const int len = a.lengths != nullptr
                      ? max(0, min(__ldg(a.lengths + bi), a.sk))
                      : a.kv_len;
  const int last = min(p0 + rt.pb, a.sq) - 1;
  const int kend = a.causal ? min(len, a.q_offset + last + 1) : len;
  const int k_lo = split * a.chunk;
  const int k_hi = min(kend, k_lo + a.chunk);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kWgKeys - 1) / kWgKeys : 0;

  // the producer: tile j into stage j % kWgStages, once the stage's last
  // tile is released (the first kWgStages go out now)
  auto load_k = [&](int j) {
    const int s = j % kWgStages;
    if (j >= kWgStages)
      repro::mbar_wait(&empty[s], ((j / kWgStages) - 1) & 1);
    repro::mbar_arrive_expect_tx(&full[s], kWgKBytes);
#pragma unroll
    for (int at = 0; at < kWgAtoms; ++at)
      repro::tma_load_4d(sK + s * kWgKBytes + at * kWgKAtom, kmap, &full[s],
                         at * kWgAtom, kvh, k_lo + j * kWgKeys, bi);
  };
  if (t == kWgProducer)
    for (int j = 0; j < min(ntiles, kWgStages); ++j) load_k(j);

  const int wg = t >> 7, tw = t & 127;
  // thread tw of warpgroup wg: rows r0 and r0 + 8 of the tile (the wgmma
  // fragment layout), columns 256·wg + 8c + 2(lane % 4) + {0, 1} of O
  const int r0 = 16 * (tw >> 5) + (lane >> 2);
  float o[2][64];
#pragma unroll
  for (int sub = 0; sub < 2; ++sub)
#pragma unroll
    for (int x = 0; x < 64; ++x) o[sub][x] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  const uint32_t q_addr = repro::smem_u32(base);
  const uint32_t k_base = repro::smem_u32(sK);
  if (wg == 0) {
    int lim[2];  // one past the last key each row sees
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, pos = p0 + r / rt.gb;
      lim[i] = row_ok(r) ? (a.causal ? min(k_hi, a.q_offset + pos + 1)
                                     : k_hi)
                         : INT_MIN;
    }
    repro::mbar_wait(qbar, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kWgStages;
      repro::mbar_wait(&full[s], (j / kWgStages) & 1);
      const uint32_t k_addr = k_base + s * kWgKBytes;
      // S = Q Kᵀ: 36 steps of 16 columns, 32 bytes into a swizzle row.  The
      // first step overwrites the accumulator, so nothing writes it while
      // the last tile's P·V is in flight.
      float sc[16];
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgEK / 16; ++kk) {
        const int at = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = repro::wgmma_desc(
            q_addr + at * kWgQAtom + off, 16, 8 * 128, repro::kSwizzle128);
        const uint64_t db = repro::wgmma_desc(
            k_addr + at * kWgKAtom + off, 16, 8 * 128, repro::kSwizzle128);
        repro::wgmma_m64nNk16_ss(sc, da, db, kk > 0);
      }
      repro::wgmma_commit();
      repro::wgmma_wait<0>();  // S, and the last tile's P·V
      repro::fence_regs(sc);
      repro::fence_regs(o[0]);
      repro::fence_regs(o[1]);
      if (j > 0) repro::mbar_arrive(&empty[(j - 1) % kWgStages]);

      // online softmax on the fragments: register 4c + 2i + jj holds row
      // r0 + 8i, key key0 + 8c + jj; a row's 32 keys lie on a quad
      const int key0 = k_lo + j * kWgKeys + 2 * (lane & 3);
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int x = 4 * c + 2 * i + jj;
            const bool ok = key0 + 8 * c + jj < lim[i];
            sc[x] = ok ? sc[x] * a.scale : -CUDART_INF_F;
            mx = fmaxf(mx, sc[x]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        // no visible key so far: p = 0 and alpha = 0, never inf - inf
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[i] = exp2f(m_run[i] - m_use);
        m_run[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int x = 4 * c + 2 * i + jj;
            sc[x] = exp2f(sc[x] - m_use);
            sum += sc[x];
          }
        l_run[i] = l_run[i] * alpha[i] + sum;  // this thread's keys
      }
      // P as the A fragments of two k16 steps, hi + lo (the S accumulator
      // layout is the A-fragment layout)
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1], ph[kk][x],
                     pl[kk][x]);
      if (j > 0) repro::named_sync(kBarPFree, kWgThreads);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          rec[(4 * kk + x) * 128 + tw] = ph[kk][x];
          rec[(8 + 4 * kk + x) * 128 + tw] = pl[kk][x];
        }
      rec[16 * 128 + tw] = __float_as_uint(alpha[0]);
      rec[17 * 128 + tw] = __float_as_uint(alpha[1]);
      repro::named_arrive(kBarPFull, kWgThreads);
      wg_pv(o, ph, pl, alpha, k_addr, 0);
    }
    repro::wgmma_wait<0>();
    repro::fence_regs(o[0]);
    repro::fence_regs(o[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
    // the last record: each row's m and l
    if (ntiles > 0) repro::named_sync(kBarPFree, kWgThreads);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rec[i * 128 + tw] = __float_as_uint(m_run[i]);
      rec[(16 + i) * 128 + tw] = __float_as_uint(l_run[i]);
    }
    repro::named_arrive(kBarPFull, kWgThreads);
  } else {
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kWgStages;
      uint32_t ph[2][4], pl[2][4];
      float alpha[2];
      repro::named_sync(kBarPFull, kWgThreads);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ph[kk][x] = rec[(4 * kk + x) * 128 + tw];
          pl[kk][x] = rec[(8 + 4 * kk + x) * 128 + tw];
        }
      alpha[0] = __uint_as_float(rec[16 * 128 + tw]);
      alpha[1] = __uint_as_float(rec[17 * 128 + tw]);
      repro::named_arrive(kBarPFree, kWgThreads);
      repro::mbar_wait(&full[s], (j / kWgStages) & 1);
      wg_pv(o, ph, pl, alpha, k_base + s * kWgKBytes, 1);
      // wait here, not at the next record: a P·V still in flight across
      // the loop's back edge makes ptxas serialise every wgmma of the
      // kernel (its note C7515), and this warpgroup has nothing to overlap
      repro::wgmma_wait<0>();
      repro::fence_regs(o[0]);
      repro::fence_regs(o[1]);
      repro::mbar_arrive(&empty[s]);
      // warpgroup 0 releases tile j once it has waited for the next S
      if (t == kWgProducer && j + kWgStages < ntiles) load_k(j + kWgStages);
    }
    repro::named_sync(kBarPFull, kWgThreads);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_run[i] = __uint_as_float(rec[i * 128 + tw]);
      l_run[i] = __uint_as_float(rec[(16 + i) * 128 + tw]);
    }
  }

  const int col = kWgHalf * wg + 2 * (lane & 3);
  if (a.nsplit == 1) {
    // through shared memory (over the Q and K tiles), so that each thread
    // stores 16 contiguous bytes of a row; a row with no visible key
    // outputs 0, as the reference does
    __syncthreads();  // both warpgroups are done with Q and K
    __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(base);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int c = 0; c < 16; ++c)
          *reinterpret_cast<__nv_bfloat162*>(so + r * kWgStageRow + col +
                                             128 * sub + 8 * c) =
              __floats2bfloat162_rn(o[sub][4 * c + 2 * i] * inv,
                                    o[sub][4 * c + 2 * i + 1] * inv);
    }
    __syncthreads();
    for (int it = t; it < kWgRows * (kWgEV / 8); it += kWgThreads) {
      const int r = it / (kWgEV / 8), q = it % (kWgEV / 8);
      if (!row_ok(r)) continue;
      const long long orow = ((long long)bi * a.sq + p0 + r / rt.gb) * a.h +
                             kvh * g + h0 + r % rt.gb;
      *reinterpret_cast<uint4*>(a.out + orow * kWgEV + 8 * q) =
          *reinterpret_cast<const uint4*>(so + r * kWgStageRow + 8 * q);
    }
    return;
  }

  // The splits of the cluster merge through distributed shared memory,
  // over the Q and K tiles: once every block is done with its tiles, each
  // stores its (O, m, l) rows into the shared memory of their owners (row
  // r's owner is block r % nsplit, which keeps it in slot (r / nsplit) ·
  // nsplit + split), 16 bytes a store; then each owner weighs each split of
  // each of its rows and folds them, in split order, from its own memory.
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();  // every block of the cluster is done with its tiles
  float* recv = reinterpret_cast<float*>(base);
  float* recv_ml = recv + kWgSlots * kWgOStride;
  float* weight = recv_ml + 2 * kWgSlots;  // [row of this block][split]
  const bool odd = lane & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const int slot = (r / a.nsplit) * a.nsplit + split;
    float* dst = cluster.map_shared_rank(recv + slot * kWgOStride,
                                         (unsigned)(r % a.nsplit));
#pragma unroll
    for (int sub = 0; sub < 2; ++sub)
#pragma unroll
      for (int c = 0; c < 16; c += 2) {
        // lanes 2k and 2k + 1 swap halves: the even one stores 4 columns
        // of chunk c, the odd one 4 of chunk c + 1
        const float lo0 = o[sub][4 * c + 2 * i];
        const float lo1 = o[sub][4 * c + 2 * i + 1];
        const float hi0 = o[sub][4 * (c + 1) + 2 * i];
        const float hi1 = o[sub][4 * (c + 1) + 2 * i + 1];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? lo0 : hi0, 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? lo1 : hi1, 1);
        const float4 v = odd ? make_float4(s0, s1, hi0, hi1)
                             : make_float4(lo0, lo1, s0, s1);
        *reinterpret_cast<float4*>(
            dst + kWgHalf * wg + 128 * sub + 8 * (c + odd) +
            2 * ((lane & 3) - odd)) = v;
      }
    if (wg == 0 && (lane & 3) == 0) {
      float* ml = cluster.map_shared_rank(recv_ml + 2 * slot,
                                          (unsigned)(r % a.nsplit));
      ml[0] = m_run[i];
      ml[1] = l_run[i];
    }
  }
  cluster.sync();  // every row is with its owner
  const int rank = (int)cluster.block_rank();
  const int nrows = (kWgRows - rank + a.nsplit - 1) / a.nsplit;
  // each row's weights: exp2(m_p - m) / l over the splits that saw a key
  // of it (0 for the others; a row with no visible key outputs 0)
  if (t < nrows) {
    const int slot0 = t * a.nsplit;
    float mm = -CUDART_INF_F, l = 0.f;
    for (int p = 0; p < a.nsplit; ++p)
      if (recv_ml[2 * (slot0 + p) + 1] > 0.f)
        mm = fmaxf(mm, recv_ml[2 * (slot0 + p)]);
    for (int p = 0; p < a.nsplit; ++p) {
      const float lp = recv_ml[2 * (slot0 + p) + 1];
      if (lp > 0.f) l += lp * exp2f(recv_ml[2 * (slot0 + p)] - mm);
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int p = 0; p < a.nsplit; ++p) {
      const float lp = recv_ml[2 * (slot0 + p) + 1];
      weight[t * kWgMaxSplit + p] =
          lp > 0.f ? exp2f(recv_ml[2 * (slot0 + p)] - mm) * inv : 0.f;
    }
  }
  __syncthreads();
  // then 4 columns of a row an item, the splits in order
  for (int it = t; it < nrows * (kWgEV / 4); it += kWgThreads) {
    const int rr = it / (kWgEV / 4), c4 = it % (kWgEV / 4);
    const int r = rank + rr * a.nsplit;
    if (!row_ok(r)) continue;
    const float* w = weight + rr * kWgMaxSplit;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < kWgMaxSplit; ++p) {
      if (p < a.nsplit) {
        const float4 v = reinterpret_cast<const float4*>(
            recv + (rr * a.nsplit + p) * kWgOStride)[c4];
        acc.x = fmaf(w[p], v.x, acc.x);
        acc.y = fmaf(w[p], v.y, acc.y);
        acc.z = fmaf(w[p], v.z, acc.z);
        acc.w = fmaf(w[p], v.w, acc.w);
      }
    }
    const long long orow = ((long long)bi * a.sq + p0 + r / rt.gb) * a.h +
                           kvh * g + h0 + r % rt.gb;
    __nv_bfloat162* op =
        reinterpret_cast<__nv_bfloat162*>(a.out + orow * kWgEV + 4 * c4);
    op[0] = __floats2bfloat162_rn(acc.x, acc.y);
    op[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

using WgFn = void (*)(CUtensorMap, CUtensorMap, WgArgs);

// One bf16 MLA call: the tensor maps over q (b, sq, h, 576; element
// strides qsb, qss, qsh) and k (b, sk, n, 576; ksb, kss, ksn), each with
// unit stride on its last axis, 16-byte aligned rows and strides, then one
// launch of `fn` (clusters of nsplit blocks when split).  Returns the
// launch's error.
inline int launch_wgmma(WgFn fn, const void* q, const void* k,
                        const WgArgs& a, int b, long long qsb, long long qss,
                        long long qsh, long long ksb, long long kss,
                        long long ksn, cudaStream_t stream) {
  if (b < 1 || a.n < 1 || a.h % a.n != 0 || a.sq < 1 || a.sk < 1 ||
      a.nsplit < 1 || a.nsplit > kWgMaxSplit || a.chunk < kWgKeys ||
      a.chunk % kWgKeys != 0)
    return cudaErrorInvalidValue;
  const WgRows rt(a.h / a.n);
  CUtensorMap qm, km;
  int err = repro::make_map_4d(&qm, q, {kWgEK, a.h, a.sq, b},
                               {1, qsh, qss, qsb}, kWgAtom, rt.gb, rt.pb,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = repro::make_map_4d(&km, k, {kWgEK, a.n, a.sk, b},
                             {1, ksn, kss, ksb}, kWgAtom, 1, kWgKeys,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  // once per library (internal linkage: each library has its own copy,
  // and launches one bf16 MLA kernel)
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, rt.tiles(a.sq), b * a.n);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.nsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.nsplit > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, qm, km, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

using AttendFn = void (*)(Args);
template <typename T>
using CombineFn = void (*)(const float*, const float*, T*, long long, int);

// One f32 MLA call: the tile kernel, then, for a split key range, the
// combine.  Returns cudaGetLastError() of the launches.
template <typename T, int EK, int EV>
int launch(AttendFn attend_fn, CombineFn<T> combine_fn, const Args& a,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<T, EK, EV>::kSmem;
  if (a.n < 1 || a.h % a.n != 0 || a.nsplit < 1 || a.chunk < 1 ||
      a.chunk % kBK != 0 || a.sq < 1 || a.sk < 1 ||
      (a.nsplit > 1 && (a.part_o == nullptr || a.part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      attend_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int mtiles = (a.sq * (a.h / a.n) + kBM - 1) / kBM;
  attend_fn<<<dim3(a.nsplit, mtiles, a.b * a.n), kThreads, smem,
              stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long rows = (long long)a.b * a.sq * a.h;
  combine_fn<<<(unsigned)((rows * EV + 255) / 256), 256, 0, stream>>>(
      a.part_o, a.part_ml, static_cast<T*>(a.out), rows, a.nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_mla
