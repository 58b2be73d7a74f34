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
// projection's shapes (2MNK int8 ops against MK + KN + 2MN bytes) at
// 1,979 TOP/s through the tensor cores, or bytes where M is small.  Two
// kernels, chosen by shape (kernels/int8_matmul.py::kernel_for):
//
// int8_mm_wgmma, where K and N are multiples of 16 (what TMA and 16-byte
// rows of w need): the int8 tensor cores.
//  * wgmma m64n64k32 s32.s8.s8 on a 64 x 64 output tile per block, so the
//    zamba2 projection (128 x 2048 x 4096) gives 128 blocks for the 132
//    SMs.  K walks in 128-byte stages through a 4-stage ring of shared
//    memory with full/empty mbarriers; one warpgroup multiplies, the other
//    fills the ring.
//  * 8-bit wgmma takes both operands K-major (no transpose bit for 8-bit
//    types, and no b8 ldmatrix.trans).  x (M,K) is K-major already and
//    arrives by TMA in the 128-byte swizzle.  w (K,N) is N-major: each
//    producer thread loads 4 rows x 16 bytes of it (4 k by 16 n) into
//    registers two stages ahead, transposes the 4 x 4 byte blocks with
//    __byte_perm, and stores 16 words of 4 k into the same swizzled
//    K-major layout the descriptor names (conflict-free: a warp's 32
//    threads cover the 128 k of 16 n).
//  * The int32 sums of the tensor cores are exact, so any order agrees
//    with the plain version bit for bit.
// int8_mm, for any other shape (e.g. the sweep's 77 x 100 x 33): a 64 x 64
// tile per block of 256 threads, each thread a 4 x 4 micro-tile
// accumulated by __dp4a on the CUDA cores over 32-deep K tiles, w's tile
// stored transposed in shared memory so four consecutive k of one column
// pack into one 32-bit word; ragged M, N and K masked with zeros.
//
// Both epilogues multiply in the plain version's order with
// round-to-nearest intrinsics (no contraction), so they agree exactly.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// int8_mm_wgmma
// ---------------------------------------------------------------------------

constexpr int kWgBM = 64, kWgBN = 64;  // output tile
constexpr int kWgBK = 128;             // K bytes per stage: one swizzle row
constexpr int kWgStages = 4;
constexpr int kWgTile = kWgBM * kWgBK;  // bytes of an A or a B stage tile
constexpr int kWgThreads = 256;         // producer + consumer warpgroups
constexpr int kWgAlign = 1024;          // the 128-byte swizzle period
constexpr size_t kWgSmem =
    kWgAlign + 2 * (size_t)kWgStages * kWgTile + 16 * kWgStages;

// Shared memory: kWgStages A tiles (64 m x 128 k, by TMA), kWgStages B
// tiles (64 n x 128 k, transposed by the producers), both K-major in the
// 128-byte swizzle; then a full and an empty mbarrier per stage.  Grid
// (N tiles, M tiles).
template <typename OutT>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_mm_wgmma(const __grid_constant__ CUtensorMap xmap,
              const int8_t* __restrict__ w, const float* __restrict__ sx,
              const float* __restrict__ sw, OutT* __restrict__ out, int M,
              int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((kWgAlign - (repro::smem_u32(smem_raw) &
                                           (kWgAlign - 1))) &
                              (kWgAlign - 1));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + 2 * kWgStages * kWgTile);
  uint64_t* empty = full + kWgStages;
  auto a_tile = [&](int s) { return base + s * kWgTile; };
  auto b_tile = [&](int s) { return base + (kWgStages + s) * kWgTile; };

  const int t = threadIdx.x;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kWgBN;
  const int nk = (K + kWgBK - 1) / kWgBK;
  if (t == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      // 128 producer arrivals, plus thread 0's arrival with the TMA bytes
      repro::mbar_init(&full[s], 129);
      repro::mbar_init(&empty[s], 128);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  if (t < 128) {
    // producer: this thread's 4 k (kk..kk+3) by 16 n (nn..nn+15) of each
    // stage's w tile
    const int kk = 4 * (t & 31), nn = 16 * (t >> 5);
    const bool col_ok = n0 + nn < N;  // N % 16 == 0: all 16 or none
    const int8_t* wp = w + n0 + nn;
    auto load = [&](int j, uint4 (&r)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = j * kWgBK + kk + i;
        r[i] = (col_ok && row < K)
                   ? __ldg(reinterpret_cast<const uint4*>(
                         wp + (long long)row * N))
                   : make_uint4(0, 0, 0, 0);
      }
    };
    auto store = [&](int j, const uint4 (&r)[4]) {
      const int s = j % kWgStages;
      if (j >= kWgStages)
        repro::mbar_wait(&empty[s], ((j / kWgStages) - 1) & 1);
      if (t == 0) {
        repro::mbar_arrive_expect_tx(&full[s], kWgTile);
        repro::tma_load_4d(a_tile(s), &xmap, &full[s], j * kWgBK, m0, 0, 0);
      }
      uint8_t* bt = b_tile(s);
      const uint32_t wr[4][4] = {{r[0].x, r[0].y, r[0].z, r[0].w},
                                 {r[1].x, r[1].y, r[1].z, r[1].w},
                                 {r[2].x, r[2].y, r[2].z, r[2].w},
                                 {r[3].x, r[3].y, r[3].z, r[3].w}};
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // bytes n = nn + 4c .. + 3
        const uint32_t t0 = __byte_perm(wr[0][c], wr[1][c], 0x5140);
        const uint32_t t1 = __byte_perm(wr[0][c], wr[1][c], 0x7362);
        const uint32_t t2 = __byte_perm(wr[2][c], wr[3][c], 0x5140);
        const uint32_t t3 = __byte_perm(wr[2][c], wr[3][c], 0x7362);
        // word i: k = kk .. kk + 3 of column nn + 4c + i
        const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                                 __byte_perm(t0, t2, 0x7632),
                                 __byte_perm(t1, t3, 0x5410),
                                 __byte_perm(t1, t3, 0x7632)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = nn + 4 * c + i;
          *reinterpret_cast<uint32_t*>(
              bt + row * kWgBK + ((((kk >> 4) ^ (row & 7))) << 4) +
              (kk & 15)) = col[i];
        }
      }
      repro::fence_proxy_async();
      repro::mbar_arrive(&full[s]);
    };
    // two stages of w loads in flight while one is stored
    uint4 ra[4], rb[4];
    load(0, ra);
    if (nk > 1) load(1, rb);
    for (int j = 0; j < nk; j += 2) {
      store(j, ra);
      if (j + 2 < nk) load(j + 2, ra);
      if (j + 1 < nk) {
        store(j + 1, rb);
        if (j + 3 < nk) load(j + 3, rb);
      }
    }
    return;
  }

  // consumer warpgroup: 4 k32 steps of wgmma per stage
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  for (int j = 0; j < nk; ++j) {
    const int s = j % kWgStages;
    repro::mbar_wait(&full[s], (j / kWgStages) & 1);
    const uint32_t a_addr = repro::smem_u32(a_tile(s));
    const uint32_t b_addr = repro::smem_u32(b_tile(s));
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk) {
      const uint64_t da = repro::wgmma_desc(a_addr + 32 * kk, 16, 8 * kWgBK,
                                            repro::kSwizzle128);
      const uint64_t db = repro::wgmma_desc(b_addr + 32 * kk, 16, 8 * kWgBK,
                                            repro::kSwizzle128);
      repro::wgmma_m64n64k32_s8(acc, da, db, 1);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(acc);
    repro::mbar_arrive(&empty[s]);  // every read of stage s has completed
  }

  // register 4c + 2i + jj holds row 16 warp + lane/4 + 8i, column
  // 8c + 2 (lane % 4) + jj of the tile
  const int tc = t - 128, lane = tc & 31, warp = tc >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 16 * warp + (lane >> 2) + 8 * i;
    if (m >= M) continue;
    const float sm = sx[m];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + 8 * c + 2 * (lane & 3);
      if (n >= N) continue;  // N even: n + 1 < N too
      const float v0 = __fmul_rn(
          __fmul_rn(__int2float_rn(acc[4 * c + 2 * i]), sm), sw[n]);
      const float v1 = __fmul_rn(
          __fmul_rn(__int2float_rn(acc[4 * c + 2 * i + 1]), sm), sw[n + 1]);
      OutT* o = out + (long long)m * N + n;
      o[0] = repro::from_f<OutT>(v0);
      o[1] = repro::from_f<OutT>(v1);
    }
  }
}

template <typename OutT>
int launch_wgmma(const void* x, const void* w, const void* sx,
                 const void* sw, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  if (K % 16 != 0 || N % 16 != 0) return cudaErrorInvalidValue;
  CUtensorMap xm;
  const long long mk = (long long)M * K;
  const int err = repro::make_map_4d(
      &xm, x, {K, M, 1, 1}, {1, K, mk, mk}, kWgBK, kWgBM, 1,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err != 0) return err;
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_mm_wgmma<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWgSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + kWgBN - 1) / kWgBN, (M + kWgBM - 1) / kWgBM);
  int8_mm_wgmma<OutT><<<grid, kWgThreads, kWgSmem, stream>>>(
      xm, static_cast<const int8_t*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
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

// x (M,K), w (K,N) int8 contiguous and 16-byte aligned; sx (M,) and sw
// (N,) f32 contiguous; out (M,N) contiguous in `out_dtype` (csrc/common.cuh
// codes).  `wgmma` != 0 runs int8_mm_wgmma (K and N multiples of 16),
// else int8_mm.
extern "C" int repro_int8_matmul(const void* x, const void* w,
                                 const void* sx, const void* sw, void* out,
                                 int out_dtype, int M, int N, int K,
                                 int wgmma, void* stream) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (out_dtype == repro::kF32)
    return wgmma ? launch_wgmma<float>(x, w, sx, sw, out, M, N, K, st)
                 : launch<float>(x, w, sx, sw, out, M, N, K, st);
  if (out_dtype == repro::kBF16)
    return wgmma
               ? launch_wgmma<__nv_bfloat16>(x, w, sx, sw, out, M, N, K, st)
               : launch<__nv_bfloat16>(x, w, sx, sw, out, M, N, K, st);
  return cudaErrorInvalidValue;
}
