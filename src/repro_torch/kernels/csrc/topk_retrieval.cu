// K3 — fused inner-product scoring + top-k for the vector-search stage.
//
// Replaces the TPU kernel repro/kernels/topk_retrieval.py::_topk_kernel
// (pallas_call at topk_retrieval.py:58).
//
// What bounds it on the H100: device-memory bytes.  Each corpus row (d f32)
// is read once and scored against a handful of queries: 2*nq flops per
// 4 bytes, far below the ridge.  What the design does about it:
//  * one block per (query tile, corpus split): the block stages QT queries
//    and a corpus tile in shared memory, scores the tile against all QT
//    queries, and keeps each query's partial top-k in shared memory, so the
//    corpus streams from device memory exactly once and no (nq, N) score
//    matrix is ever written;
//  * the corpus is split across blocks to fill the SMs; a merge kernel (one
//    block per query) folds the per-split lists;
//  * a candidate tile is sorted into the running list only when one of its
//    scores beats the current k-th, so after the first tiles most tiles
//    cost their scores alone.
// Order: values descending, ties to the lower corpus index, as
// jax.lax.top_k (topk_retrieval.py:42).  Rows >= N never enter.  k <= 256.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kQT = 16;        // queries per block
constexpr int kTN = 128;       // corpus rows per tile
constexpr int kDC = 32;        // feature chunk staged per step
constexpr int kThreads = 256;  // kTN rows x 2 query halves
constexpr int kMergeThreads = 1024;
constexpr int kMergeSort = 2048;  // running list + candidate tile

// "a comes before b": larger value first, then the lower index
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Bitonic sort of `rows` independent arrays of length `len` (a power of
// two) laid out back to back in shared memory; all threads take part.
__device__ void block_sort(float* v, int* id, int rows, int len) {
  const int half = len >> 1;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < rows * half; p += blockDim.x) {
        const int row = p / half, pi = p % half;
        const int i = 2 * stride * (pi / stride) + (pi % stride);
        const int j = i + stride;
        float* rv = v + row * len;
        int* ri = id + row * len;
        const bool up = (i & size) == 0;
        const float vi = rv[i], vj = rv[j];
        const int ii = ri[i], ij = ri[j];
        if (up ? before(vj, ij, vi, ii) : before(vi, ii, vj, ij)) {
          rv[i] = vj; rv[j] = vi;
          ri[i] = ij; ri[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

// Scores corpus rows [split*rows_per, min(N, (split+1)*rows_per)) against
// queries [qt*kQT, ...) and writes each query's k best to part_v/part_i
// (nq, nsplit, k).  Shared layout: qs[kQT][kDC], cs[kTN][kDC+1], then
// cand_v/cand_i [kQT][sort_len] whose first kp entries are the running
// sorted list.
__global__ void __launch_bounds__(kThreads)
topk_partial(const float* __restrict__ queries,
             const float* __restrict__ corpus, float* __restrict__ part_v,
             int* __restrict__ part_i, int nq, int N, int d, int k, int kp,
             int sort_len, int rows_per, int nsplit) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* cs = qs + kQT * kDC;
  float* cand_v = cs + kTN * (kDC + 1);
  int* cand_i = reinterpret_cast<int*>(cand_v + kQT * sort_len);
  const int t = threadIdx.x;
  const int qt = blockIdx.x, split = blockIdx.y;
  const int row_lo = split * rows_per;
  const int row_hi = min(N, row_lo + rows_per);
  const int r = t % kTN, qh = t / kTN;  // this thread's row, query half
  constexpr int kQPer = kQT / 2;

  for (int i = t; i < kQT * sort_len; i += kThreads) {
    cand_v[i] = -CUDART_INF_F;
    cand_i[i] = INT_MAX;
  }
  __syncthreads();

  for (int row0 = row_lo; row0 < row_hi; row0 += kTN) {
    float acc[kQPer];
#pragma unroll
    for (int qq = 0; qq < kQPer; ++qq) acc[qq] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kDC) {
      for (int i = t; i < kQT * kDC; i += kThreads) {
        const int qi = qt * kQT + i / kDC, c = d0 + i % kDC;
        qs[i] = (qi < nq && c < d) ? queries[(long long)qi * d + c] : 0.f;
      }
      for (int i = t; i < kTN * kDC; i += kThreads) {
        const int rr = i / kDC, c = i % kDC;
        const int row = row0 + rr;
        cs[rr * (kDC + 1) + c] = (row < row_hi && d0 + c < d)
                                     ? corpus[(long long)row * d + d0 + c]
                                     : 0.f;
      }
      __syncthreads();
      const float* crow = cs + r * (kDC + 1);
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const float x = crow[c];
#pragma unroll
        for (int qq = 0; qq < kQPer; ++qq)
          acc[qq] += qs[(qh * kQPer + qq) * kDC + c] * x;
      }
      __syncthreads();
    }
    // drop this tile's candidates into the free tail of each list
    const int row = row0 + r;
    bool beats = false;
#pragma unroll
    for (int qq = 0; qq < kQPer; ++qq) {
      const int q = qh * kQPer + qq;
      float* cv = cand_v + q * sort_len;
      int* ci = cand_i + q * sort_len;
      const bool valid = row < row_hi;
      const float sv = valid ? acc[qq] : -CUDART_INF_F;
      const int si = valid ? row : INT_MAX;
      beats |= valid && before(sv, si, cv[k - 1], ci[k - 1]);
      cv[kp + r] = sv;
      ci[kp + r] = si;
    }
    for (int i = kp + kTN + t; i < sort_len; i += kThreads) {
      // the slack beyond the tile (sort_len is a power of two)
      for (int q = 0; q < kQT; ++q) {
        cand_v[q * sort_len + i] = -CUDART_INF_F;
        cand_i[q * sort_len + i] = INT_MAX;
      }
    }
    if (__syncthreads_or(beats)) block_sort(cand_v, cand_i, kQT, sort_len);
  }
  for (int i = t; i < kQT * k; i += kThreads) {
    const int q = i / k, j = i % k;
    const int qi = qt * kQT + q;
    if (qi < nq) {
      const long long o = ((long long)qi * nsplit + split) * k + j;
      part_v[o] = cand_v[q * sort_len + j];
      part_i[o] = cand_i[q * sort_len + j];
    }
  }
}

// One block per query: folds the nsplit partial lists of k into the k best.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
           float* __restrict__ out_v, int* __restrict__ out_i, int k, int kp,
           int n_cand) {
  __shared__ float cv[kMergeSort];
  __shared__ int ci[kMergeSort];
  const int q = blockIdx.x, t = threadIdx.x;
  const int tile = kMergeSort - kp;
  const float* pv = part_v + (long long)q * n_cand;
  const int* pi = part_i + (long long)q * n_cand;
  for (int i = t; i < kp; i += kMergeThreads) {
    cv[i] = -CUDART_INF_F;
    ci[i] = INT_MAX;
  }
  __syncthreads();
  for (int c0 = 0; c0 < n_cand; c0 += tile) {
    bool beats = false;
    for (int i = t; i < tile; i += kMergeThreads) {
      const bool valid = c0 + i < n_cand;
      const float sv = valid ? pv[c0 + i] : -CUDART_INF_F;
      const int si = valid ? pi[c0 + i] : INT_MAX;
      beats |= before(sv, si, cv[k - 1], ci[k - 1]);
      cv[kp + i] = sv;
      ci[kp + i] = si;
    }
    if (__syncthreads_or(beats)) block_sort(cv, ci, 1, kMergeSort);
  }
  for (int i = t; i < k; i += kMergeThreads) {
    out_v[(long long)q * k + i] = cv[i];
    out_i[(long long)q * k + i] = ci[i];
  }
}

}  // namespace

// queries (nq,d) and corpus (N,d) row-major f32.  With nsplit == 1 the
// partial lists are the result and part_v/part_i must be out_v/out_i;
// otherwise part_* are (nq, nsplit, k) scratch and the merge writes out_*.
extern "C" int repro_topk_retrieval(const void* queries, const void* corpus,
                                    void* part_v, void* part_i, void* out_v,
                                    void* out_i, int nq, int N, int d, int k,
                                    int kp, int sort_len, int rows_per,
                                    int nsplit, void* stream) {
  if (k < 1 || k > kp || kp > 256 || sort_len < kp + kTN)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (kQT * kDC + kTN * (kDC + 1)) +
                      (sizeof(float) + sizeof(int)) * kQT * sort_len;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + kQT - 1) / kQT, nsplit);
  topk_partial<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(corpus),
      static_cast<float*>(part_v), static_cast<int*>(part_i), nq, N, d, k,
      kp, sort_len, rows_per, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  topk_merge<<<nq, kMergeThreads, 0, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), k, kp,
      nsplit * k);
  return cudaGetLastError();
}
