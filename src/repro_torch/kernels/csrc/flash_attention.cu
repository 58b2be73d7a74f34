// K2 — GQA flash-attention forward (FA2-style online softmax).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:87), and adds what the serving path
// needs that the Pallas kernel lacks: a query position offset (prefill into
// a cache at cache_idx > 0) and a valid KV length.
//
// What bounds it on the H100: operations.  A (sq x sk) tile pair costs
// 4*e flops per score against 2*e*2 bytes per K/V row, so at the path's
// sq >= 16 it sits above the bytes line; the card's 989 TFLOP/s bf16 peak
// is reached only through wgmma.  This first version is the simple, right
// one: CUDA-core f32 FMAs over tiles staged in shared memory.  What its
// design does about the bound: every K/V tile is loaded once per block and
// reused by all BQ query rows; scores never leave shared memory; causal
// blocks stop at the last key any of their rows can see.  wgmma and TMA
// are later work.
//
// Semantics follow the reference `mha`: scores = q.k / sqrt(e) in f32,
// causal mask q_offset + qpos >= kpos, keys kpos >= kv_len masked, the
// unnormalised probabilities are rounded to V's dtype before P.V, f32
// accumulation, fully masked rows output 0.  q-head hh reads kv head
// hh / (h/n), the (b,sq,n,g,e) grouping of layers._gqa_scores.
#include "common.cuh"

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBQ / kWarps;

template <int E>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * E + 2 * kBK * (E + 1) + kBQ * kBK + 2 * kBQ);
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int sq, int h,
          int n, int kv_len, int q_offset, int causal, long long qsb,
          long long qss, long long qsh, long long ksb, long long kss,
          long long ksn, long long vsb, long long vss, long long vsn) {
  constexpr int kTPC = kThreads / E;
  constexpr int kRows = kBQ / kTPC;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][E]
  float* ks = qs + kBQ * E;                // [kBK][E + 1]
  float* vs = ks + kBK * (E + 1);          // [kBK][E + 1]
  float* ps = vs + kBK * (E + 1);          // [kBQ][kBK]
  float* alpha_s = ps + kBQ * kBK;         // [kBQ]
  float* l_s = alpha_s + kBQ;              // [kBQ]

  const int q0 = blockIdx.x * kBQ, hh = blockIdx.y, bi = blockIdx.z;
  const int kvh = hh / (h / n);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* qb = q + bi * qsb + hh * qsh;
  const T* kb = k + bi * ksb + kvh * ksn;
  const T* vb = v + bi * vsb + kvh * vsn;

  for (int i = t; i < kBQ * E; i += kThreads) {
    const int r = i / E, j = i % E;
    qs[i] = (q0 + r < sq) ? repro::to_f(qb[(long long)(q0 + r) * qss + j])
                          : 0.f;
  }
  // the last key any row of this block may attend to, plus one
  int kend = kv_len;
  if (causal) kend = min(kend, q_offset + min(q0 + kBQ, sq));
  const float sqrt_e = sqrtf((float)E);

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }
  const int col = t % E, row0 = t / E;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, kend - k0);
    __syncthreads();
    for (int i = t; i < kBK * E; i += kThreads) {
      const int r = i / E, j = i % E;
      float kv = 0.f, vv = 0.f;
      if (r < nk) {
        kv = repro::to_f(kb[(long long)(k0 + r) * kss + j]);
        vv = repro::to_f(vb[(long long)(k0 + r) * vss + j]);
      }
      ks[r * (E + 1) + j] = kv;
      vs[r * (E + 1) + j] = vv;
    }
    __syncthreads();
    // scores: warp w owns rows w, w+4, ...; lane = key
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = ks + lane * (E + 1);
#pragma unroll 4
    for (int j = 0; j < E; ++j) {
      const float kj = krow[j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] += qs[(warp + kWarps * r) * E + j] * kj;
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = warp + kWarps * r;
      const bool valid =
          lane < nk && (!causal || q_offset + q0 + qi >= kpos);
      const float sv = valid ? s[r] / sqrt_e : -CUDART_INF_F;
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
        a += ps[qi * kBK + kk] * vs[kk * (E + 1) + col];
      acc[r] = a;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) l_s[warp + kWarps * r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + kTPC * r;
    if (q0 + qi < sq) {
      const float l = l_s[qi];
      out[(((long long)bi * sq + q0 + qi) * h + hh) * E + col] =
          repro::from_f<T>(l > 0.f ? acc[r] / l : 0.f);
    }
  }
}

template <typename T, int E>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int h, int n, int kv_len, int q_offset, int causal,
           long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksn, long long vsb, long long vss,
           long long vsn, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<E>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd<T, E><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, h, n, kv_len,
      q_offset, causal, qsb, qss, qsh, ksb, kss, ksn, vsb, vss, vsn);
  return cudaGetLastError();
}

}  // namespace

// q (b,sq,h,e), k/v (b,sk,n,e): unit stride on e, element strides for the
// other axes (a cache prefix view is read in place); out (b,sq,h,e)
// contiguous in q's dtype.  kv_len <= sk keys are visible.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int b,
    int sq, int h, int n, int e, int kv_len, int q_offset, int causal,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksn, long long vsb, long long vss,
    long long vsn, void* stream) {
  if (h % n != 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T, E)                                                 \
  return launch<T, E>(q, k, v, out, b, sq, h, n, kv_len, q_offset, causal, \
                      qsb, qss, qsh, ksb, kss, ksn, vsb, vss, vsn, st)
  if (dtype == repro::kF32) {
    if (e == 16) REPRO_FLASH(float, 16);
    if (e == 64) REPRO_FLASH(float, 64);
    if (e == 128) REPRO_FLASH(float, 128);
  } else if (dtype == repro::kBF16) {
    if (e == 16) REPRO_FLASH(__nv_bfloat16, 16);
    if (e == 64) REPRO_FLASH(__nv_bfloat16, 64);
    if (e == 128) REPRO_FLASH(__nv_bfloat16, 128);
  }
#undef REPRO_FLASH
  return cudaErrorInvalidValue;
}
