// K4 — int8 x int8 matrix product with per-row and per-column dequant.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::_int8_kernel
// (pallas_call at int8_matmul.py:50):
//
//   out[m][n] = (float(sum_k x[m][k] w[k][n]) * sx[m]) * sw[n]
//
// with x (M,K) and w (K,N) int8 row-major, the sum in int32, sx (M,1) and
// sw (1,N) f32, out (M,N) bf16 or f32.
//
// What bounds it on the H100: operations at the bench's and the zamba2
// projection's shapes (2MNK int8 ops against MK + KN + 2MN bytes), at
// 1,979 TOP/s through the tensor cores.  This first version is the simple,
// right one: a 64 x 64 output tile per block of 256 threads, each thread a
// 4 x 4 micro-tile accumulated by __dp4a (four int8 products a cycle on
// the CUDA cores, well below the tensor cores' rate; wgmma s8 is later
// work).  The TPU kernel carries its int32 accumulator across the K grid
// axis in VMEM scratch; here one block walks the whole K axis in 32-deep
// tiles, so the sum never leaves registers.  w's tile is stored
// transposed in shared memory, so four consecutive k of one column pack
// into one 32-bit word for __dp4a.  Ragged M, N and K are masked with
// zeros.  The epilogue multiplies in the plain version's order with
// round-to-nearest intrinsics (no contraction), so the two agree exactly.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdw = kBK / 4 + 1;   // words per smem row, padded

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_mm(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ sx, const float* __restrict__ sw,
        OutT* __restrict__ out, int M, int N, int K) {
  __shared__ int xs[kBM * kLdw];   // x rows, 4 consecutive k per word
  __shared__ int ws[kBN * kLdw];   // w columns, 4 consecutive k per word
  int8_t* xb = reinterpret_cast<int8_t*>(xs);
  int8_t* wb = reinterpret_cast<int8_t*>(ws);

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  int acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    for (int e = t; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int m = m0 + r, kk = k0 + k;
      xb[r * kLdw * 4 + k] =
          (m < M && kk < K) ? x[(long long)m * K + kk] : (int8_t)0;
    }
    for (int e = t; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, c = e % kBN;   // coalesced along n
      const int n = n0 + c, kk = k0 + k;
      wb[c * kLdw * 4 + k] =
          (n < N && kk < K) ? w[(long long)kk * N + n] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBK / 4; ++kw) {
      int xa[4], wc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xa[a] = xs[(ty + 16 * a) * kLdw + kw];
#pragma unroll
      for (int c = 0; c < 4; ++c) wc[c] = ws[(tx + 16 * c) * kLdw + kw];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = __dp4a(xa[a], wc[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + ty + 16 * a;
    if (m >= M) continue;
    const float sm = sx[m];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N)
        out[(long long)m * N + n] = repro::from_f<OutT>(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[a][c]), sm), sw[n]));
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* sx, const void* sw,
           void* out, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_mm<OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (M,K), w (K,N) int8 contiguous; sx (M,) and sw (N,) f32 contiguous;
// out (M,N) contiguous in `out_dtype` (csrc/common.cuh codes).
extern "C" int repro_int8_matmul(const void* x, const void* w,
                                 const void* sx, const void* sw, void* out,
                                 int out_dtype, int M, int N, int K,
                                 void* stream) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (out_dtype == repro::kF32)
    return launch<float>(x, w, sx, sw, out, M, N, K, st);
  if (out_dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, w, sx, sw, out, M, N, K, st);
  return cudaErrorInvalidValue;
}
