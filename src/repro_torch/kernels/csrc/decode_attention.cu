// K1 — GQA split-KV flash-decoding for one new token per sequence.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (pallas_call at decode_attention.py:93).
//
// What bounds it on the H100: device-memory bytes.  Each step reads the
// valid prefix of the K and V caches once (b * len * n * e * 2 tensors) and
// does ~4 flops per cached element, far below the ~295 flop/byte ridge of
// bf16 on this card.  What the design does about it:
//  * the (b, S, n, e) per-layer cache is read in place through its strides
//    (the TPU wrapper transposes it into a copy first, decode_attention.py:75);
//  * one block per (b, kv head, KV split) holds the g = h/n query heads of its
//    kv head, so each K/V row staged in shared memory serves all g heads and
//    the cache is read exactly once;
//  * the KV axis is split across blocks so a short batch still spreads over
//    the 132 SMs; blocks past a row's length exit at once, and a second small
//    kernel combines the per-split (max, sum, acc) with the usual rescale.
// Semantics follow the reference `mha`, not the Pallas kernel: a row with
// lengths[b] == 0 outputs 0 (the Pallas -1e30 sentinel returns mean(V)).
#include "common.cuh"

namespace {

constexpr int kBK = 32;        // keys per tile: one per lane
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;      // query heads per kv head

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             float* __restrict__ part_o, float* __restrict__ part_ml,
             int h, int n, int S, int chunk, int nsplit,
             long long ksb, long long kss, long long ksn,
             long long vsb, long long vss, long long vsn) {
  constexpr int kTPC = kThreads / E;          // threads per output column
  constexpr int kRows = (kMaxG + kTPC - 1) / kTPC;
  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int g = h / n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int len = max(0, min(lengths[bi], S));
  const int start = split * chunk;
  const int stop = min(start + chunk, len);
  if (start >= stop) return;  // the combine kernel skips empty splits

  __shared__ float qs[kMaxG][E];
  __shared__ float ks[kBK][E + 1];
  __shared__ float vs[kBK][E + 1];
  __shared__ float ps[kMaxG][kBK];
  __shared__ float alpha_s[kMaxG];

  for (int i = t; i < g * E; i += kThreads) {
    const int gi = i / E, j = i % E;
    qs[gi][j] = repro::to_f(q[((long long)bi * h + kvh * g + gi) * E + j]);
  }
  const float sqrt_e = sqrtf((float)E);
  float m_run[kMaxG / kWarps], l_run[kMaxG / kWarps];
#pragma unroll
  for (int r = 0; r < kMaxG / kWarps; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }
  const int col = t % E, row0 = t / E;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  const T* kb = k + bi * ksb + kvh * ksn;
  const T* vb = v + bi * vsb + kvh * vsn;
  for (int k0 = start; k0 < stop; k0 += kBK) {
    const int nk = min(kBK, stop - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = t; i < kBK * E; i += kThreads) {
      const int r = i / E, j = i % E;
      float kv = 0.f, vv = 0.f;
      if (r < nk) {
        kv = repro::to_f(kb[(long long)(k0 + r) * kss + j]);
        vv = repro::to_f(vb[(long long)(k0 + r) * vss + j]);
      }
      ks[r][j] = kv;
      vs[r][j] = vv;
    }
    __syncthreads();
    // scores and online softmax: warp w owns heads w, w+4, ...; lane = key
#pragma unroll
    for (int r = 0; r < kMaxG / kWarps; ++r) {
      const int gi = warp + kWarps * r;
      if (gi < g) {
        float s = 0.f;
#pragma unroll 8
        for (int j = 0; j < E; ++j) s += qs[gi][j] * ks[lane][j];
        s = s / sqrt_e;
        const bool valid = lane < nk;
        s = valid ? s : -CUDART_INF_F;
        const float m_new = fmaxf(m_run[r], repro::warp_max(s));
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
        l_run[r] = alpha * l_run[r] + repro::warp_sum(p);
        m_run[r] = m_new;
        ps[gi][lane] = p;
        if (lane == 0) alpha_s[gi] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int gi = row0 + kTPC * r;
      if (gi < g) {
        float a = acc[r] * alpha_s[gi];
        for (int kk = 0; kk < nk; ++kk) a += ps[gi][kk] * vs[kk][col];
        acc[r] = a;
      }
    }
  }

  const long long slot = ((long long)bi * n + kvh) * nsplit + split;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gi = row0 + kTPC * r;
    if (gi < g) part_o[(slot * g + gi) * E + col] = acc[r];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kMaxG / kWarps; ++r) {
      const int gi = warp + kWarps * r;
      if (gi < g) {
        part_ml[(slot * g + gi) * 2] = m_run[r];
        part_ml[(slot * g + gi) * 2 + 1] = l_run[r];
      }
    }
  }
}

// one block per (b, q head); thread j owns output column j
template <typename T, int E>
__global__ void decode_combine(const float* __restrict__ part_o,
                               const float* __restrict__ part_ml,
                               const int* __restrict__ lengths,
                               T* __restrict__ out, int h, int n, int S,
                               int chunk, int nsplit) {
  const int bi = blockIdx.x / h, hh = blockIdx.x % h;
  const int g = h / n, kvh = hh / g, gi = hh % g;
  const int j = threadIdx.x;
  const int len = max(0, min(lengths[bi], S));
  const int nact = (len + chunk - 1) / chunk;
  const long long base = ((long long)bi * n + kvh) * nsplit;
  float m = -CUDART_INF_F;
  for (int s = 0; s < nact; ++s)
    m = fmaxf(m, part_ml[((base + s) * g + gi) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nact; ++s) {
    const long long slot = (base + s) * g + gi;
    const float w = expf(part_ml[slot * 2] - m);
    l += part_ml[slot * 2 + 1] * w;
    acc += part_o[slot * E + j] * w;
  }
  // a row with no valid key (length 0) outputs 0, as the reference does
  out[((long long)bi * h + hh) * E + j] =
      repro::from_f<T>(l > 0.f ? acc / l : 0.f);
}

template <typename T, int E>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* part_o, float* part_ml, void* out, int b, int h, int n,
           int S, int chunk, int nsplit, long long ksb, long long kss,
           long long ksn, long long vsb, long long vss, long long vsn,
           cudaStream_t stream) {
  decode_split<T, E><<<dim3(nsplit, n, b), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_o, part_ml, h, n, S, chunk,
      nsplit, ksb, kss, ksn, vsb, vss, vsn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, E><<<b * h, E, 0, stream>>>(
      part_o, part_ml, lengths, static_cast<T*>(out), h, n, S, chunk, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q (b,h,e) contiguous; k/v (b,S,n,e) with unit stride on e and element
// strides (ksb,kss,ksn); lengths (b,) int32; part_o (b,n,nsplit,g,e) and
// part_ml (b,n,nsplit,g,2) f32 scratch; out (b,h,e) contiguous, q's dtype.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* part_o, void* part_ml, void* out, int dtype, int b, int h, int n,
    int S, int e, int chunk, int nsplit, long long ksb, long long kss,
    long long ksn, long long vsb, long long vss, long long vsn,
    void* stream) {
  if (h % n != 0 || h / n > kMaxG) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto li = static_cast<const int*>(lengths);
  auto po = static_cast<float*>(part_o);
  auto pm = static_cast<float*>(part_ml);
#define REPRO_DECODE(T, E)                                                   \
  return launch<T, E>(q, k, v, li, po, pm, out, b, h, n, S, chunk, nsplit,  \
                      ksb, kss, ksn, vsb, vss, vsn, st)
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
