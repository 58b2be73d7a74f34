// K1 — GQA flash-decoding for one new token per sequence, in one launch.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (pallas_call at decode_attention.py:93).
//
// What bounds it on the H100: device-memory bytes in principle (each step
// reads the valid prefix of the K and V caches once and does ~4 flops per
// cached element, far below the ~295 flop/byte ridge of bf16), but at the
// serving paths' shapes the bytes take well under a microsecond (32 keys on
// the RAG path, at most 923 on the zamba2 engine), so what costs is
// latency: launches, round trips to device memory, serial chains and idle
// warps.  What the design does about it:
//  * One launch per call.  A block takes one (b, key split) and either
//    the g = h/n query heads of a kv head, so each K row it loads serves
//    all g scores, or, on a short row (every call of the RAG path: at
//    most 32 keys), a single query head, so the g blocks of a kv head run
//    side by side on more SMs and each does 1/g of the math (they read
//    the same few rows, from L2).  When one split covers a row the block
//    normalises and writes `out` itself; no partials, no scratch, no
//    second kernel.  kernels/decode_attention.py::split_plan chooses the
//    heads, the split and the warps (4, or 8 for a single head on a long
//    row).
//  * Several splits (the engine's long rows, only while the b·n blocks
//    would leave SMs idle) run as one thread-block cluster of nsplit <= 8
//    blocks (cudaLaunchKernelEx with a cluster dimension) and merge their
//    (m, l, acc) through distributed shared memory: every block reads the
//    others' results with cluster.map_shared_rank after a cluster
//    barrier, and each writes its share of the output.  Chosen over a
//    last-block-done merge because it needs no workspace and no counter,
//    so nothing is shared between calls or between the streams calls may
//    come from, and the partials never leave the SMs.  The kernel reads
//    %cluster_nctarank and traps if the launch did not form the cluster
//    it was planned with.  A cluster costs about as much as one more load
//    step (measured), so a split takes at least two steps.
//  * Every warp on keys, lanes on the head dimension.  A K or V row is
//    read with 16-byte loads (8 bf16 or 4 f32 a lane), so E/8 (bf16) or
//    E/4 (f32) lanes share a row and a warp reads 32/that rows a step;
//    each partial dot product is reduced with __shfl_xor_sync inside the
//    lane group.  q for the block's heads stays in registers, and each K
//    row loaded once serves all their scores.
//  * Each lane group keeps its own online softmax (m, l, acc) for the
//    block's heads over U rows a step (one rescale per U rows); the
//    groups merge by shuffles inside a warp, the warps through shared
//    memory, the splits through the cluster.
//  * The next step's 16-byte loads are issued before the current step's
//    math (a register double buffer), so on the engine's longest rows the
//    loads overlap the FMAs; the first step's go out before lengths[b]
//    arrives.
//  * Window mode (window > 0; the hybrid family's sliding-window ring
//    cache): key slot j has position kv_positions[j], and the query of
//    row b at q_pos[b] sees it iff q_pos[b] - window < kpos <= q_pos[b],
//    tested in 64 bits so that an empty slot's NEG_POS = -2^30 cannot
//    overflow.  Slot order is not position order, so every slot below
//    lengths[b] is visited (a ring passes lengths = S) and masked one by
//    one; each lane group loads its rows' positions with their K/V rows,
//    one step ahead.
// Numerics: scores q.k in f32, times log2(e)/sqrt(e) so that softmax runs
// on exp2f; the unnormalised probabilities are rounded to V's type before
// P.V (the reference `mha` rounds the normalised ones: both are within
// bf16's 2e-2, and in f32 the rounding is exact).  Semantics follow `mha`,
// not the Pallas kernel: a row with lengths[b] == 0 outputs 0 (the Pallas
// -1e30 sentinel returns mean(V)).
//
// MLA mode (decode_mla_wgmma, decode_mla, decode_mla_combine): DeepSeek's
// absorbed decode, 128 query heads over one 576-wide latent key row per
// position, values its first 512 columns, an explicit scale; mla.cuh's
// tile loops, shared with K2's MLA mode: bf16 on wgmma with TMA-fed tiles,
// a split row merged inside its cluster (decode_mla_wgmma, one launch),
// f32 on the CUDA cores (decode_mla, + decode_mla_combine when split).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "mla.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplit = 8;   // the portable cluster size

// rows each lane group takes per step: its registers hold q and acc for
// the G heads and two steps of K/V rows
template <int G> __host__ __device__ constexpr int rows_per_step() {
  return G <= 4 ? 4 : 2;
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Grid (nsplit, n * g / heads, b), clusters of (nsplit, 1, 1), W warps a
// block.  Block (split, y, bi) takes keys [split * chunk, min((split + 1)
// * chunk, len)) of row bi for query heads [part * heads, + heads) of kv
// head kvh, where y = kvh * (g / heads) + part; heads <= G.
template <typename T, int E, int G, int W>
__global__ void __launch_bounds__(32 * W)
decode_attn(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ lengths,
            const int* __restrict__ kv_positions,
            const int* __restrict__ q_pos, T* __restrict__ out, int h, int n,
            int S, int chunk, int nsplit, int heads, int window,
            long long ksb, long long kss, long long ksn, long long vsb,
            long long vss, long long vsn) {
  constexpr int kThreads = 32 * W;
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int kLpr = E / kVec;            // lanes per key row
  constexpr int kRpw = 32 / kLpr;           // rows per warp per step
  constexpr int kGroups = W * kRpw;         // lane groups in the block
  constexpr int kU = rows_per_step<G>();    // rows per lane group per step
  static_assert(kLpr >= 1 && kLpr <= 32, "head dim");

  __shared__ float red_acc[W][G][E];  // per warp; then the block's
  __shared__ float red_ml[W][G][2];
  __shared__ float blk_ml[G][2];

  const int g = h / n, parts = g / heads;
  const int split = blockIdx.x, bi = blockIdx.z;
  const int kvh = blockIdx.y / parts;
  const int head0 = kvh * g + (blockIdx.y % parts) * heads;  // first q head
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sub = lane / kLpr, li = lane % kLpr;
  const int gid = warp * kRpw + sub;
  const int start = split * chunk;
  // the split's rows that lie in the cache: the first step's loads go out
  // with these bounds, before lengths[bi] arrives (rows past the length
  // are in the cache and are masked below)
  const int stop_s = min(start + chunk, S);
  const int len = max(0, min(lengths[bi], S));
  const int stop = min(start + chunk, len);
  const int niter =
      stop > start ? (stop - start + kGroups * kU - 1) / (kGroups * kU) : 0;
  // window mode: slot j is visible iff w_lo < kpos(j) <= w_hi
  const long long w_hi = window > 0 ? (long long)q_pos[bi] : 0;
  const long long w_lo = w_hi - window;

  // scores in base-2 units: exp(s / sqrt(E) - m) = exp2(s * scale - m')
  const float scale = 1.4426950408889634f / sqrtf((float)E);
  float qf[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < heads) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(
          q + ((long long)bi * h + head0 + gi) * E + li * kVec));
      unpack(r, qf[gi]);
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x) qf[gi][x] = 0.f;
    }
  }
  float m_run[G], l_run[G], acc[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m_run[gi] = -CUDART_INF_F;
    l_run[gi] = 0.f;
#pragma unroll
    for (int x = 0; x < kVec; ++x) acc[gi][x] = 0.f;
  }

  const T* kb = k + bi * ksb + kvh * ksn + li * kVec;
  const T* vb = v + bi * vsb + kvh * vsn + li * kVec;
  auto key_of = [&](int it, int u) {
    return start + (it * kU + u) * kGroups + gid;
  };
  auto load = [&](int it, int bound, uint4 (&kr)[kU], uint4 (&vr)[kU],
                  int (&pr)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int key = key_of(it, u);
      pr[u] = key;  // read only in window mode, which has positions
      if (key < bound) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + key * kss));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + key * vss));
        if (kv_positions != nullptr) pr[u] = __ldg(kv_positions + key);
      } else {
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  uint4 kc[kU], vc[kU];
  int pc[kU];  // the rows' positions (window mode)
  load(0, stop_s, kc, vc, pc);
  for (int it = 0; it < niter; ++it) {
    uint4 kn[kU], vn[kU];
    int pn[kU];
    if (it + 1 < niter) load(it + 1, stop, kn, vn, pn);  // in flight meanwhile
    float s[kU][G];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kVec];
      unpack(kc[u], kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int x = 0; x < kVec; ++x) d = fmaf(qf[gi][x], kf[x], d);
        s[u][gi] = d;
      }
    }
#pragma unroll
    for (int o = kLpr / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          s[u][gi] += __shfl_xor_sync(0xffffffffu, s[u][gi], o);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long kp = pc[u];
      const bool valid = key_of(it, u) < stop &&
                         (window <= 0 || (kp > w_lo && kp <= w_hi));
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        s[u][gi] = valid ? s[u][gi] * scale : -CUDART_INF_F;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = s[0][gi];
#pragma unroll
      for (int u = 1; u < kU; ++u) mx = fmaxf(mx, s[u][gi]);
      const float m_new = fmaxf(m_run[gi], mx);
      // no valid key so far: p = 0 and alpha = 0, never inf - inf
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m_run[gi] - m_use);
      m_run[gi] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        s[u][gi] = exp2f(s[u][gi] - m_use);
        sum += s[u][gi];
      }
      l_run[gi] = l_run[gi] * alpha + sum;
#pragma unroll
      for (int x = 0; x < kVec; ++x) acc[gi][x] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[kVec];
      unpack(vc[u], vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = repro::round_to<T>(s[u][gi]);
#pragma unroll
        for (int x = 0; x < kVec; ++x) acc[gi][x] = fmaf(p, vf[x], acc[gi][x]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
      pc[u] = pn[u];
    }
  }

  // merge the lane groups of a warp (same slice li, other rows)
#pragma unroll
  for (int o = kLpr; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[gi], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l_run[gi], o);
      const float mm = fmaxf(m_run[gi], mo);
      const float mu = mm == -CUDART_INF_F ? 0.f : mm;
      const float a = exp2f(m_run[gi] - mu), c = exp2f(mo - mu);
      l_run[gi] = l_run[gi] * a + lo * c;
      m_run[gi] = mm;
#pragma unroll
      for (int x = 0; x < kVec; ++x)
        acc[gi][x] =
            acc[gi][x] * a + __shfl_xor_sync(0xffffffffu, acc[gi][x], o) * c;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int x = 0; x < kVec; ++x)
        red_acc[warp][gi][li * kVec + x] = acc[gi][x];
      if (li == 0) {
        red_ml[warp][gi][0] = m_run[gi];
        red_ml[warp][gi][1] = l_run[gi];
      }
    }
  }
  __syncthreads();

  // merge the warps: the block's (m, l) per head into blk_ml, its acc
  // into red_acc[0] (each element read and written by one thread)
  const uint32_t csize = repro::cluster_nctarank();
  if (csize != (uint32_t)nsplit) __trap();  // the planned cluster did not form
  for (int idx = t; idx < heads * E; idx += kThreads) {
    const int gi = idx / E, j = idx % E;
    float mm = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < W; ++w) mm = fmaxf(mm, red_ml[w][gi][0]);
    const float mu = mm == -CUDART_INF_F ? 0.f : mm;
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float c = exp2f(red_ml[w][gi][0] - mu);
      l += red_ml[w][gi][1] * c;
      a += red_acc[w][gi][j] * c;
    }
    if (csize == 1) {
      // a row with no valid key (length 0) outputs 0, as the reference does
      out[((long long)bi * h + head0 + gi) * E + j] =
          repro::from_f<T>(l > 0.f ? a / l : 0.f);
    } else {
      red_acc[0][gi][j] = a;
      if (j == 0) {
        blk_ml[gi][0] = mm;
        blk_ml[gi][1] = l;
      }
    }
  }
  if (csize == 1) return;

  // merge the splits through distributed shared memory: block `rank`
  // writes the output elements [rank * kThreads, + kThreads), then
  // every nsplit * kThreads on (over heads * E)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's (m, l, acc) is in its shared memory
  const int rank = (int)cluster.block_rank();
  for (int idx = rank * kThreads + t; idx < heads * E;
       idx += (int)csize * kThreads) {
    const int gi = idx / E, j = idx % E;
    float mm = -CUDART_INF_F, ms[kMaxSplit], ls[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      ms[r] = -CUDART_INF_F;
      ls[r] = 0.f;
      if (r < (int)csize) {
        const float* ml = cluster.map_shared_rank(&blk_ml[gi][0], r);
        ms[r] = ml[0];
        ls[r] = ml[1];
      }
      mm = fmaxf(mm, ms[r]);
    }
    const float mu = mm == -CUDART_INF_F ? 0.f : mm;
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < (int)csize) {
        const float c = exp2f(ms[r] - mu);
        l += ls[r] * c;
        a += *cluster.map_shared_rank(&red_acc[0][gi][j], r) * c;
      }
    }
    out[((long long)bi * h + head0 + gi) * E + j] =
        repro::from_f<T>(l > 0.f ? a / l : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its memory
}

template <typename T, int E, int G, int W>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const int* kv_positions, const int* q_pos, void* out, int b, int h,
           int n, int S, int chunk, int nsplit, int heads, int window,
           long long ksb, long long kss, long long ksn, long long vsb,
           long long vss, long long vsn, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, h / heads, b);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attn<T, E, G, W>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      kv_positions, q_pos, static_cast<T*>(out), h, n, S, chunk, nsplit,
      heads, window, ksb, kss, ksn, vsb, vss, vsn);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the template of the smallest G that holds `heads`; 8 warps only for a
// single head (the plan's long rows of g = 1)
template <typename T, int E>
int launch_g(const void* q, const void* k, const void* v,
             const int* lengths, const int* kv_positions, const int* q_pos,
             void* out, int b, int h, int n, int S, int chunk, int nsplit,
             int heads, int warps, int window, long long ksb, long long kss,
             long long ksn, long long vsb, long long vss, long long vsn,
             cudaStream_t stream) {
#define REPRO_DECODE(G, W)                                                   \
  return launch<T, E, G, W>(q, k, v, lengths, kv_positions, q_pos, out, b,  \
                            h, n, S, chunk, nsplit, heads, window, ksb, kss, \
                            ksn, vsb, vss, vsn, stream)
  if (warps == 8 && heads == 1) REPRO_DECODE(1, 8);
  if (warps != 4) return cudaErrorInvalidValue;
  if (heads <= 1) REPRO_DECODE(1, 4);
  if (heads <= 2) REPRO_DECODE(2, 4);
  if (heads <= 4) REPRO_DECODE(4, 4);
  if (heads <= 8) REPRO_DECODE(8, 4);
  REPRO_DECODE(16, 4);
#undef REPRO_DECODE
}

// MLA mode: mla.cuh's tile loop with one query per batch row
template <typename T, int EK, int EV>
__global__ void __launch_bounds__(repro_mla::kThreads, 2)
decode_mla(const repro_mla::Args a) {
  extern __shared__ __align__(16) unsigned char mla_smem[];
  repro_mla::attend<T, EK, EV>(a, mla_smem);
}

// MLA mode in bf16: mla.cuh's wgmma tile loop, one query a row
__global__ void __launch_bounds__(repro_mla::kWgThreads, 1)
decode_mla_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const repro_mla::WgArgs a) {
  extern __shared__ __align__(16) uint8_t mla_wg_smem[];
  repro_mla::attend_wgmma(&qmap, &kmap, a, mla_wg_smem);
}

template <typename T, int EV>
__global__ void __launch_bounds__(256)
decode_mla_combine(const float* part_o, const float* part_ml, T* out,
                   long long rows, int nsplit) {
  repro_mla::combine<T, EV>(part_o, part_ml, out, rows, nsplit);
}

template <typename T, int EK, int EV>
int launch_mla(const repro_mla::Args& a, cudaStream_t stream) {
  return repro_mla::launch<T, EK, EV>(
      decode_mla<T, EK, EV>, decode_mla_combine<T, EV>, a, stream);
}

}  // namespace

// q (b,h,e) contiguous; k/v (b,S,n,e) with unit stride on e and element
// strides (ksb,kss,ksn), every strided row 16-byte aligned; lengths (b,)
// int32; out (b,h,e) contiguous, q's dtype.  window > 0 is the window
// mode: q_pos (b,) int32 and kv_positions (S,) int32.  The plan (chunk,
// nsplit, heads, warps) is decode_attention.py::split_plan's: nsplit <= 8
// blocks (one cluster) covering S, `heads` query heads a block (dividing
// g = h/n, at most 16) and `warps` warps a block (4, or 8 for one head).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* kv_positions, const void* q_pos, void* out, int dtype, int b,
    int h, int n, int S, int e, int chunk, int nsplit, int heads, int warps,
    int window, long long ksb, long long kss, long long ksn, long long vsb,
    long long vss, long long vsn, void* stream) {
  if (n < 1 || h % n != 0 || nsplit < 1 || nsplit > kMaxSplit ||
      chunk < 1 || (long long)chunk * nsplit < S || heads < 1 ||
      heads > 16 || (h / n) % heads != 0 ||
      (window > 0) != (kv_positions != nullptr) ||
      (window > 0 && q_pos == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto li = static_cast<const int*>(lengths);
  auto kp = static_cast<const int*>(kv_positions);
  auto qp = static_cast<const int*>(q_pos);
#define REPRO_DECODE(T, E)                                                  \
  return launch_g<T, E>(q, k, v, li, kp, qp, out, b, h, n, S, chunk,        \
                        nsplit, heads, warps, window, ksb, kss, ksn, vsb,   \
                        vss, vsn, st)
  if (dtype == repro::kF32) {
    if (e == 16) REPRO_DECODE(float, 16);
    if (e == 64) REPRO_DECODE(float, 64);
    if (e == 128) REPRO_DECODE(float, 128);
  } else if (dtype == repro::kBF16) {
    if (e == 16) REPRO_DECODE(__nv_bfloat16, 16);
    if (e == 64) REPRO_DECODE(__nv_bfloat16, 64);
    if (e == 128) REPRO_DECODE(__nv_bfloat16, 128);
  }
#undef REPRO_DECODE
  return cudaErrorInvalidValue;
}

// MLA mode: q (b,h,ek) with element strides (qsb, qsh); k (b,S,n,ek) with
// unit stride on the last axis, the values its first ev columns (read
// from the K tile); lengths (b,) int32; out (b,h,ev) contiguous in q's
// dtype; scale multiplies q.k (log2(e) is applied here).  (ek, ev) =
// (576, 512) only: DeepSeek's absorbed decode over its latent cache.
// bf16 runs decode_mla_wgmma (wgmma = 1) with the plan (chunk, nsplit) of
// flash_attention.py::mla_wgmma_plan: nsplit <= 8 blocks a row tile, one
// cluster, covering S; q and k must be TMA-ready (16-byte aligned, strides
// multiples of 16 bytes).  f32 runs decode_mla with mla_plan's, and
// part_o (nsplit,b,h,ev) and part_ml (nsplit,b,h,2) are its f32 scratch
// when nsplit > 1.
extern "C" int repro_decode_mla(
    const void* q, const void* k, const void* lengths, void* out,
    void* part_o, void* part_ml, int dtype, int b, int h, int n, int S,
    int ek, int ev, float scale, int chunk, int nsplit, long long qsb,
    long long qsh, long long ksb, long long kss, long long ksn, int wgmma,
    void* stream) {
  if (lengths == nullptr || ek != 576 || ev != 512)
    return cudaErrorInvalidValue;
  const float scale2 = scale * 1.4426950408889634f;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16 && wgmma) {
    if ((long long)chunk * nsplit < S) return cudaErrorInvalidValue;
    const repro_mla::WgArgs a{static_cast<__nv_bfloat16*>(out),
                              static_cast<const int*>(lengths), 1, h, n, S,
                              S, 0, 0, chunk, nsplit, scale2};
    return repro_mla::launch_wgmma(decode_mla_wgmma, q, k, a, b, qsb,
                                   (long long)h * qsh, qsh, ksb, kss, ksn,
                                   st);
  }
  if (dtype != repro::kF32 || wgmma) return cudaErrorInvalidValue;
  repro_mla::Args a{q, k, static_cast<const int*>(lengths), out,
                    static_cast<float*>(part_o),
                    static_cast<float*>(part_ml), b, 1, h, n, S, S, 0, 0,
                    chunk, nsplit, scale2, qsb, 0, qsh, ksb, kss, ksn};
  return launch_mla<float, 576, 512>(a, st);
}
