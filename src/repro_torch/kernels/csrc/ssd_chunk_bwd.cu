// K5's backward — the gradients of the Mamba2 SSD intra-chunk term.
//
// The JAX package has no backward Pallas kernel: it differentiates
// repro/models/ssm.py::mamba2_forward (the intra-chunk term and the chunk
// states) with XLA.  This is the gradient of K5 (csrc/ssd_chunk.cu), per
// (batch, chunk, head), with Q <= 256 and P, N <= 64:
//
//   forward   cs = cumsum(dA) (f64, rounded once to f32),  dtx_j = dt_j x_j
//             s_ij = C_i . B_j,   L_ij = exp(cs_i - cs_j) (i >= j; 0 above
//             the diagonal, masked BEFORE exp),   M = s ⊙ L
//             y = M dtx,   w_j = exp(cs_last - cs_j),   S = (B ⊙ w)ᵀ dtx
//   given     dy (Q x P) and dS (N x P), both f32:
//             dM_ij  = dy_i . dtx_j                           (i >= j)
//             d(dtx) = Mᵀ dy + w ⊙ (B dS)
//             dx_j   = dt_j d(dtx)_j,   ddt_j = x_j . d(dtx)_j
//             dC     = (dM ⊙ L) B
//             dB     = (dM ⊙ L)ᵀ C + w ⊙ (dtx dSᵀ)
//   and dA.   L_ij depends on cs_i - cs_j = dA_{j+1} + ... + dA_i, and
//             dL_ij L_ij = dM_ij s_ij L_ij = dM_ij M_ij =: G_ij, so
//             d cs_i gets G's row sum and loses its column sum (G's
//             diagonal cancels and is left out of both).  w_j depends on
//             cs_last - cs_j; with dw_j = B_j . (dS dtx_j), d cs_last
//             gets sum_j dw_j w_j and d cs_j loses dw_j w_j.  cs_i sums
//             dA_0..dA_i, so ddA_k = sum_{i >= k} d cs_i, which is
//
//             ddA_k = sum_{i >= k} (rowsum_i G - colsum_i G)
//                     + sum_{j < k} dw_j w_j
//
//             (the w terms summed forward, which is the same sum without
//             its cancellation).  Both sums run in f64 and round once, as
//             the forward's scan.  ddA_0 is 0: dA_0 enters no difference.
//
// Every kernel recomputes cs, L and the scores from the saved inputs; no
// exp is taken of a positive exponent (the mask comes first, and w_j has
// cs_last <= cs_j for decays dA <= 0).  A padded row (dt = 0) has dtx = 0,
// so it adds nothing and its gradients stay finite.
//
// B and C come per head, through their strides (a stride-0 view broadcast
// from one group to every head costs no copy), and dB, dC leave per head:
// autograd's backward of the model's broadcast (expand or
// repeat_interleave) sums a group's heads, a fixed-order reduction.  The
// kernel keeps one cell's work in one block's loop, so nothing crosses
// blocks but three f32 vectors per cell, and no float atomic is used: two
// runs give the same bits.
//
// What bounds it on the H100.  At the hybrid train shape (b 4, two chunks
// of 256, 64 heads of P = N = 64) the five Q x Q products (s, dM, Mᵀ dy,
// dC, dB) over the Q(Q+1)/2 visible pairs and the state terms come to
// about 25 MFLOP a cell, 12.9 GFLOP a launch: operations, 50 us at the
// bound's prices (the scores at the bf16 rate; Mᵀ dy, both operands f32,
// at f32 accuracy on the TF32 tensor cores split three ways, 165
// TFLOP/s; the rest, each with a bf16 operand exact in TF32, at two
// products, 247.5 TFLOP/s); the bytes (about 112 MB in bf16, the
// per-head dB and dC included) take 33 us.
// dy and dS are f32, so every product with them needs f32 accuracy: one
// TF32 or bf16 rounding of an f32 operand would not hold it.  Two routes,
// chosen by ssd_chunk_bwd.py::plan:
//
// * bf16 with P and N multiples of 8: ssd_bwd_keys_mma, then
//   ssd_bwd_queries_mma, on the tensor cores (mma.sync, as the forward's
//   ssd_chunk_mma).  A block of 4 warps per (head, batch x chunk, 64-row
//   tile), each warp a 16-row stripe of the tile, in one of the two roles,
//   a kernel each, so that each has its own register budget (the key role
//   holds two accumulators, the query role one) and the profiler gives
//   the time of each:
//   - ssd_bwd_keys_mma: the tile's keys j (B_j and x_j in registers as
//     mma fragments) walk the query tiles i >= j, whose C_i and dy_i
//     arrive by 16-byte cp.async in two stages (tile i+1's copy overlaps
//     tile i's products); dy_i is split into TF32 halves once per element
//     as its stage lands.  It adds the state terms first and writes dx,
//     ddt, dB, G's column sums and the w terms.  Its tiles are transposed
//     (rows are keys), so G's column sums and the products over i live in
//     the warp's own rows.
//   - ssd_bwd_queries_mma: the tile's queries i (C_i, and dy_i split into
//     TF32 halves, in registers) walk the key tiles j <= i, B_j and x_j by
//     cp.async in two stages; it writes dC and G's row sums.
//   The diagonal is cut at 16 rows: a 16 x 16 unit wholly above it is
//   skipped (at Q = 256, 34,816 pairs a cell where 32,896 are visible).
//   The scores s = C Bᵀ (sᵀ = B Cᵀ in the key role) run on the bf16
//   tensor cores (m16n8k16: exact products, f32 sums).  Products with an
//   f32 operand run on the TF32 tensor cores (m16n8k8), each f32 operand
//   split into TF32 halves hi + lo: Mᵀ dy takes three products (hi·hi +
//   hi·lo + lo·hi); where the other operand is bf16, exact in TF32, two
//   (hi·b + lo·b): dC = (dM ⊙ L) B, dB = (dM ⊙ L)ᵀ C, and dM itself,
//   computed as (dy xᵀ) ⊙ dt_j (dt_j scales a key's column, so dt·x never
//   needs a split), as are the state terms w ⊙ (B_j dS) and w ⊙ (dt_j ⊙
//   (x_j dSᵀ)).  The products that go on from the scores take their A
//   operand from registers: with the columns of an 8-column step in the
//   order (0,2,4,6 | 1,3,5,7), the m16n8 accumulator is the m16n8k8 A
//   fragment.  L = exp(cs_i - cs_j) is applied to the fragments in
//   registers, masked first.  B fragments come from shared memory by
//   ldmatrix where their layout allows (.trans for a bf16 operand whose k
//   runs down the rows), row strides padded against bank conflicts.
//   Shared memory: 71 KB a key block, 38 KB a query block; registers
//   (ptxas: no spill) hold each kernel to 2 blocks an SM.
// * f32, and any P or N not a multiple of 8: ssd_bwd_tiles<T>, the port's
//   first version, on the CUDA cores.  A block of 256 threads per (head,
//   batch x chunk, role tile), 64 x 64 tiles, i >= j, each thread a 4 x 4
//   patch, both roles in one launch (blockIdx.z interleaves them, longest
//   first), each recomputing s, dM and L over whole diagonal tiles.
//
// Both routes end in ssd_bwd_finish: a block per (head, batch x chunk),
// the f64 scans of the row and column sums and the w terms into ddA.
#include "common.cuh"
#include "hopper.cuh"

namespace {

struct Strides {
  long long b, c, q, h;
};

constexpr int kThreads = 256;
constexpr int kT = 64;        // rows, keys per tile, padded P and N
constexpr int kLd = kT + 1;   // shared-memory row stride (no bank conflicts)
constexpr int kMaxQ = 256;    // one scan element per thread
constexpr int kParts = 3;     // a cell's row sums, column sums, w terms

constexpr size_t kSmem = kMaxQ * sizeof(double) + kMaxQ * sizeof(float) +
                         6 * kT * kLd * sizeof(float);

// rows r0..r0+63 of a (rows x W) tile with row stride rs into dst[64][kLd]
// as f32, zero past `rows` and W; each row times scale[q * ss] if given
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int rows,
                                          int W,
                                          const float* scale = nullptr,
                                          long long ss = 0) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT, q = r0 + r;
    float v = 0.f;
    if (q < rows && c < W) {
      v = repro::to_f(src[q * rs + c]);
      if (scale != nullptr) v *= scale[q * ss];
    }
    dst[r * kLd + c] = v;
  }
}

// s[a][c] = A[ty+16a] . Bm[tx+16c] over K columns (both row-major tiles)
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bm, int K, int ty,
                                         int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * kLd + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bm[(tx + 16 * c) * kLd + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] += av[a] * bv[c];
  }
}

// acc[a][c] += sum_{r < R} A[r][ty+16a] * Bm[r][tx+16c]  (Aᵀ Bm)
__device__ __forceinline__ void tile_tn(float (&acc)[4][4], const float* A,
                                        const float* Bm, int R, int ty,
                                        int tx) {
  for (int r = 0; r < R; ++r) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[r * kLd + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bm[r * kLd + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] += av[a] * bv[c];
  }
}

// sum over the 16 lanes of a half warp (the tx of one ty), fixed order
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_tiles(const T* __restrict__ x, const float* __restrict__ dt,
              const T* __restrict__ B, const T* __restrict__ C,
              const float* __restrict__ dA, const float* __restrict__ dy,
              const float* __restrict__ dS, T* __restrict__ dx,
              float* __restrict__ ddt, T* __restrict__ dB,
              T* __restrict__ dC, float* __restrict__ part, int nc, int Q,
              int H, int P, int N, Strides xs, Strides dts, Strides Bs,
              Strides Cs, Strides dAs) {
  extern __shared__ double smem_d[];
  double* scan = smem_d;                                     // [kMaxQ]
  float* cs = reinterpret_cast<float*>(scan + kMaxQ);        // [kMaxQ]
  float* Bt = cs + kMaxQ;                                    // B_j
  float* Xt = Bt + kT * kLd;                                 // dtx_j
  float* Ct = Xt + kT * kLd;                                 // C_i (dS)
  float* Yt = Ct + kT * kLd;                                 // dy_i
  float* Mt = Yt + kT * kLd;                                 // M (i, j)
  float* Dt = Mt + kT * kLd;                                 // dM ⊙ L

  const int h = blockIdx.x, bz = blockIdx.y;
  const int bi = bz / nc, ci = bz % nc;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int nT = (Q + kT - 1) / kT;
  const bool key_role = (blockIdx.z & 1) == 0;
  const int tile = key_role ? blockIdx.z / 2 : nT - 1 - blockIdx.z / 2;

  const T* xb = x + bi * xs.b + ci * xs.c + h * xs.h;
  const float* dtb = dt + bi * dts.b + ci * dts.c + h * dts.h;
  const T* Bb = B + bi * Bs.b + ci * Bs.c + h * Bs.h;
  const T* Cb = C + bi * Cs.b + ci * Cs.c + h * Cs.h;
  const float* dAb = dA + bi * dAs.b + ci * dAs.c + h * dAs.h;
  const long long row = (long long)H * P;          // dy's and dx's row
  const long long cell = (long long)bz * Q * H + h;  // (b, c, q = 0, h)
  const float* dyb = dy + cell * P;
  float* pb = part + ((long long)bz * H + h) * kParts * Q;

  // cs = cumsum(dA): Hillis-Steele scan in f64, rounded once to f32
  if (t < Q) scan[t] = (double)dAb[t * dAs.q];
  __syncthreads();
  for (int off = 1; off < Q; off <<= 1) {
    const double v = (t < Q && t >= off) ? scan[t - off] : 0.0;
    __syncthreads();
    if (t < Q) scan[t] += v;
    __syncthreads();
  }
  if (t < Q) cs[t] = (float)scan[t];
  __syncthreads();

  float s[4][4], d[4][4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  if (!key_role) {
    // ---- query tile i0..i0+63: dC_i and G's row sums over keys j <= i
    const int i0 = tile * kT;
    load_tile(Ct, Cb, Cs.q, i0, Q, N);
    load_tile(Yt, dyb, row, i0, Q, P);
    float rowp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int jt = 0; jt <= tile; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      load_tile(Bt, Bb, Bs.q, j0, Q, N);
      load_tile(Xt, xb, xs.q, j0, Q, P, dtb, dts.q);
      __syncthreads();
      tile_dot(s, Ct, Bt, N, ty, tx);
      tile_dot(d, Yt, Xt, P, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          // mask first: exp only of cs_i - cs_j <= 0
          const float L = (i < Q && j <= i) ? expf(cs[i] - cs[j]) : 0.f;
          if (j < i) rowp[a] += d[a][c] * (s[a][c] * L);
          Dt[(ty + 16 * a) * kLd + tx + 16 * c] = d[a][c] * L;
        }
      }
      __syncthreads();
      // dC_i += (dM ⊙ L)_ij B_j: rows i, columns n
      for (int r = 0; r < kT; ++r) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = Dt[(ty + 16 * a) * kLd + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bt[r * kLd + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += av[a] * bv[c];
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      const float r = half_warp_sum(rowp[a]);
      if (i >= Q) continue;
      if (tx == 0) pb[i] = r;
      T* dCr = dC + ((long long)bz * Q * H + (long long)i * H + h) * N;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = tx + 16 * c;
        if (n < N) dCr[n] = repro::from_f<T>(acc[a][c]);
      }
    }
    return;
  }

  // ---- key tile j0..j0+63: dx, ddt, dB and G's column sums over i >= j
  const int j0 = tile * kT;
  float accB[4][4];
  load_tile(Bt, Bb, Bs.q, j0, Q, N);
  load_tile(Xt, xb, xs.q, j0, Q, P, dtb, dts.q);
  // the state terms, dS (N x P) in Ct's place:
  //   acc  = w_j (B_j dS)_p,   accB = w_j (dS dtx_j)_n = w_j u_jn
  load_tile(Ct, dS + ((long long)bz * H + h) * N * P, P, 0, N, P);
  __syncthreads();
  {
    float u[4][4];
    tile_dot(u, Xt, Ct, P, ty, tx);             // u[j][n] = dtx_j . dS_n
    float bds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) bds[a][c] = 0.f;
    // (B_j dS)_p = sum_n B[j][n] dS[n][p]
    for (int n = 0; n < N; ++n) {
      float bv[4], sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = Bt[(ty + 16 * a) * kLd + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) sv[c] = Ct[n * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) bds[a][c] += bv[a] * sv[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      const float w = j < Q ? expf(cs[Q - 1] - cs[j]) : 0.f;
      float dw = 0.f;                           // B_j . u_j, this lane's n
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dw += Bt[(ty + 16 * a) * kLd + tx + 16 * c] * u[a][c];
        acc[a][c] = w * bds[a][c];
        accB[a][c] = w * u[a][c];
      }
      dw = half_warp_sum(dw);
      if (tx == 0 && j < Q) pb[2 * Q + j] = dw * w;
    }
  }
  float colp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = tile; it < nT; ++it) {
    const int i0 = it * kT;
    __syncthreads();
    load_tile(Ct, Cb, Cs.q, i0, Q, N);
    load_tile(Yt, dyb, row, i0, Q, P);
    __syncthreads();
    tile_dot(s, Ct, Bt, N, ty, tx);
    tile_dot(d, Yt, Xt, P, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        const float L = (i < Q && j <= i) ? expf(cs[i] - cs[j]) : 0.f;
        const float m = s[a][c] * L;
        if (j < i) colp[c] += d[a][c] * m;
        Mt[(ty + 16 * a) * kLd + tx + 16 * c] = m;
        Dt[(ty + 16 * a) * kLd + tx + 16 * c] = d[a][c] * L;
      }
    }
    __syncthreads();
    const int rows = min(kT, Q - i0);
    tile_tn(acc, Mt, Yt, rows, ty, tx);         // d(dtx)_j += Mᵀ dy
    tile_tn(accB, Dt, Ct, rows, ty, tx);        // dB_j += (dM ⊙ L)ᵀ C
  }
  // G's column sums: this thread's 4 columns over its rows, then the 16
  // row groups in order through shared memory (Mt is free now)
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) Mt[ty * kLd + tx + 16 * c] = colp[c];
  __syncthreads();
  if (t < kT && j0 + t < Q) {
    float v = 0.f;
    for (int r = 0; r < 16; ++r) v += Mt[r * kLd + t];
    pb[Q + j0 + t] = v;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    const bool live = j < Q;
    const long long q = live ? j : 0;
    const float dtj = live ? dtb[q * dts.q] : 0.f;
    float g = 0.f;                        // x_j . d(dtx)_j, lane's columns
    T* dxr = dx + (cell + q * H) * P;
    T* dBr = dB + (cell + q * H) * N;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;        // p of acc, n of accB
      if (live && col < P) {
        g += repro::to_f(xb[q * xs.q + col]) * acc[a][c];
        dxr[col] = repro::from_f<T>(dtj * acc[a][c]);
      }
      if (live && col < N) dBr[col] = repro::from_f<T>(accB[a][c]);
    }
    g = half_warp_sum(g);
    if (tx == 0 && live) ddt[cell + q * H] = g;
  }
}

// ddA_k = sum_{i >= k} (row_i - col_i) + sum_{j < k} wt_j, both in f64
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish(const float* __restrict__ part, float* __restrict__ ddA,
               int Q, int H) {
  __shared__ double rev[kMaxQ], fwd[kMaxQ];
  const int h = blockIdx.x, bz = blockIdx.y, t = threadIdx.x;
  const float* pb = part + ((long long)bz * H + h) * kParts * Q;
  // rev[t] holds row - col of row Q-1-t (a reversed prefix sum), fwd[t]
  // the w term of row t-1 (an exclusive one)
  rev[t] = t < Q ? (double)pb[Q - 1 - t] - (double)pb[2 * Q - 1 - t] : 0.0;
  fwd[t] = (t >= 1 && t < Q) ? (double)pb[2 * Q + t - 1] : 0.0;
  __syncthreads();
  for (int off = 1; off < Q; off <<= 1) {
    const double r = t >= off ? rev[t - off] : 0.0;
    const double f = t >= off ? fwd[t - off] : 0.0;
    __syncthreads();
    rev[t] += r;
    fwd[t] += f;
    __syncthreads();
  }
  if (t < Q)
    ddA[((long long)bz * Q + t) * H + h] = (float)(rev[Q - 1 - t] + fwd[t]);
}

// ---------------------------------------------------------------------------
// ssd_bwd_keys_mma, ssd_bwd_queries_mma: bf16, tensor cores
// ---------------------------------------------------------------------------

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::mma_tf32;
using repro::split_tf32;
using repro::u32_at;

constexpr int kMmaThreads = 128;   // 4 warps, a 16-row stripe of a tile each
constexpr int kLdK = kT + 8;       // bf16 row stride of C, B, x tiles
constexpr int kLdF = kT + 4;       // f32 row stride of dy and dt·x's halves

// Shared-memory layout of one block, in bytes, for a chunk padded to Qp =
// 64 x tiles rows.  The row strides put the rows a fragment read touches
// in distinct banks.  Key role: two stages of C_i (bf16 [64][kLdK]) and
// dy_i (f32 [64][kLdF]; split in place into its TF32 lo half as the stage
// lands) and one buffer of dy_i's TF32 hi half (u32 [64][kLdF]).  Query
// role: two stages of B_j and x_j (bf16 [64][kLdK] each).  Both: cs and
// dt (f32 [Qp]), the scan's warp totals and cs at row Q - 1 (f64 [5]).
// ssd_chunk_bwd.py::mma_smem gives the same total.
struct BwdLayout {
  int a, b, stage, hi, cs, dt, wsum, total;
  __host__ __device__ BwdLayout(int Qp, bool keys) {
    a = 0;                                       // C_i | B_j
    b = kT * kLdK * 2;                           // dy_i | x_j
    stage = b + (keys ? kT * kLdF * 4 : kT * kLdK * 2);
    hi = 2 * stage;                              // dy_i, TF32 hi
    cs = hi + (keys ? kT * kLdF * 4 : 0);
    dt = cs + Qp * 4;
    wsum = dt + Qp * 4;
    total = wsum + 5 * 8;
  }
};

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// sum over the 4 lanes of a fragment row (tq = 0..3), fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// cs = cumsum(dA) and dt of rows 0..Qp-1 into shared memory: a thread sums
// rows 2t and 2t + 1 in f64, a warp-shuffle scan and the warps' totals in
// order give each row's prefix, rounded once to f32 (sums of f32 decays in
// f64 are exact at any chunk length here, so any order gives the plain
// version's cs).  Rows Q..Qp-1 take cs at row Q - 1 and dt 0: no decay,
// and no exp of a positive exponent.
__device__ __forceinline__ void scan_cs(const float* dAb, long long dAq,
                                        const float* dtb, long long dtq,
                                        int Q, int Qp, float* css,
                                        float* dts, double* wsum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, r0 = 2 * t;
  const double d0 = r0 < Q ? (double)dAb[r0 * dAq] : 0.0;
  const double d1 = r0 + 1 < Q ? (double)dAb[(r0 + 1) * dAq] : 0.0;
  if (r0 < Qp) {
    dts[r0] = r0 < Q ? dtb[r0 * dtq] : 0.f;
    dts[r0 + 1] = r0 + 1 < Q ? dtb[(r0 + 1) * dtq] : 0.f;
  }
  double v = d0 + d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  const double before = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  double pre = lane > 0 ? before : 0.0;
  for (int w = 0; w < warp; ++w) pre += wsum[w];
  const double c0 = pre + d0, c1 = c0 + d1;
  if (r0 == Q - 1) wsum[4] = c0;
  if (r0 + 1 == Q - 1) wsum[4] = c1;
  __syncthreads();
  const float last = (float)wsum[4];
  if (r0 < Qp) {
    css[r0] = r0 < Q ? (float)c0 : last;
    css[r0 + 1] = r0 + 1 < Q ? (float)c1 : last;
  }
  __syncthreads();
}

// rows 64 it .. 64 it + 63 of a (Q x W) tile by 16-byte cp.async into dst
// (row stride ld elements of E bytes), rows past Q as zeros; W is a
// multiple of 16 / E.  A thread takes one 16-byte column slot of every
// (threads / slots)-th row.
template <typename E>
__device__ __forceinline__ void issue_tile(E* dst, int ld, const E* src,
                                           long long stride, int W, int it,
                                           int Q) {
  constexpr int V = 16 / sizeof(E), S = kT / V, R = kMmaThreads / S;
  const int c = V * (threadIdx.x % S);
  if (c >= W) return;
  for (int r = threadIdx.x / S; r < kT; r += R) {
    const int q = it * kT + r;
    if (q < Q)
      cp_async16(dst + r * ld + c, src + q * stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

// zeros in columns W..63 of a 64-row tile (a stage's columns past P or N,
// which no copy writes)
template <typename E>
__device__ __forceinline__ void zero_cols(E* dst, int ld, int W) {
  for (int e = threadIdx.x; e < kT * kT; e += kMmaThreads)
    if (e % kT >= W) dst[(e / kT) * ld + e % kT] = E(0.f);
}

// The 16 x 8 f32 accumulator (rows r, r + 8; columns c0, c0 + 1 of an
// 8-column step) as the TF32 halves of an m16n8k8 A fragment whose k-slot
// tq is column c0 and tq + 4 column c0 + 1.
__device__ __forceinline__ void acc_to_a(const float (&v)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32(v[0], hi[0], lo[0]);
  split_tf32(v[2], hi[1], lo[1]);
  split_tf32(v[1], hi[2], lo[2]);
  split_tf32(v[3], hi[3], lo[3]);
}

// The bf16 A fragments (k = the N state columns, 4 steps of 16) of rows
// ra and rb = ra + 8 of a (rows x N) matrix in global memory, columns past
// N as zeros.
__device__ __forceinline__ void score_a(uint32_t (&f)[4][4],
                                        const __nv_bfloat16* ra,
                                        const __nv_bfloat16* rb, int N,
                                        int tq) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 16 * kk + 8 * (r >> 1);
      f[kk][r] = c < N ? u32_at(((r & 1) ? rb : ra) + c + 2 * tq) : 0u;
    }
}

// x_j's bf16 pair of rows r and r + 8 (packed, each in its own register
// half) as the TF32 A fragment of an m16n8k8 step: bf16 is exact in TF32
__device__ __forceinline__ void pair_to_a(uint32_t ra, uint32_t rb,
                                          uint32_t (&a)[4]) {
  a[0] = ra << 16;
  a[1] = rb << 16;
  a[2] = ra & 0xffff0000u;
  a[3] = rb & 0xffff0000u;
}

// ---- key role: keys j0..j0+63, a warp's stripe jw..jw+15 (rows ja = jw + g
// and jb = ja + 8 of its fragments); walks the query tiles i >= j.  Every
// product below issues its mma.sync for 2 to 4 accumulators in turn: a
// warp waits on each dependent one.
__global__ void __launch_bounds__(kMmaThreads, 2)
ssd_bwd_keys_mma(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dt,
                 const __nv_bfloat16* __restrict__ B,
                 const __nv_bfloat16* __restrict__ C,
                 const float* __restrict__ dA, const float* __restrict__ dy,
                 const float* __restrict__ dS, __nv_bfloat16* __restrict__ dx,
                 float* __restrict__ ddt, __nv_bfloat16* __restrict__ dB,
                 float* __restrict__ part, int nc, int Q, int H, int P, int N,
                 Strides xs, Strides dts_, Strides Bs, Strides Cs,
                 Strides dAs) {
  extern __shared__ float4 smem_v[];
  char* sm = reinterpret_cast<char*>(smem_v);
  const int nT = (Q + kT - 1) / kT, Qp = nT * kT;
  const BwdLayout lay(Qp, true);
  uint32_t* Hi = reinterpret_cast<uint32_t*>(sm + lay.hi);
  float* css = reinterpret_cast<float*>(sm + lay.cs);
  float* dts = reinterpret_cast<float*>(sm + lay.dt);
  double* wsum = reinterpret_cast<double*>(sm + lay.wsum);

  const int h = blockIdx.x, bz = blockIdx.y, tile = blockIdx.z;  // 0 first:
  const int bi = bz / nc, ci = bz % nc;                 // it has most tiles
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* xb = x + bi * xs.b + ci * xs.c + h * xs.h;
  const __nv_bfloat16* Bb = B + bi * Bs.b + ci * Bs.c + h * Bs.h;
  const __nv_bfloat16* Cb = C + bi * Cs.b + ci * Cs.c + h * Cs.h;
  const long long row = (long long)H * P;            // dy's and dx's row
  const long long cell = (long long)bz * Q * H + h;  // (b, c, q = 0, h)
  const float* dyb = dy + cell * P;
  float* pb = part + ((long long)bz * H + h) * kParts * Q;
  const int n = nT - tile;                           // query tiles to walk

  auto Cst = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(sm + s * lay.stage + lay.a);
  };
  auto Yst = [&](int s) {
    return reinterpret_cast<float*>(sm + s * lay.stage + lay.b);
  };
  auto issue = [&](int s, int it) {
    issue_tile(Cst(s), kLdK, Cb, Cs.q, N, it, Q);
    issue_tile(Yst(s), kLdF, dyb, row, P, it, Q);
  };
  for (int s = 0; s < 2; ++s) {
    zero_cols(Cst(s), kLdK, N);
    zero_cols(Yst(s), kLdF, P);
  }
  // the first query tile, and dS (N x P) in the second stage's dy place
  // for the state terms; the second tile follows them
  const float* Ds = Yst(1);
  issue(0, tile);
  cp_async_commit();
  issue_tile(Yst(1), kLdF, dS + ((long long)bz * H + h) * N * P, P, P, 0,
             N);
  cp_async_commit();
  scan_cs(dA + bi * dAs.b + ci * dAs.c + h * dAs.h, dAs.q,
          dt + bi * dts_.b + ci * dts_.c + h * dts_.h, dts_.q, Q, Qp, css,
          dts, wsum);

  const int jw = tile * kT + 16 * warp, ja = jw + g, jb = ja + 8;
  const bool live = jw < Q;
  // B_j's rows (a row past the chunk reads the last one: it only feeds
  // its own row of the products, which is not written)
  const __nv_bfloat16* bra = Bb + min(ja, Q - 1) * Bs.q;
  const __nv_bfloat16* brb = Bb + min(jb, Q - 1) * Bs.q;
  uint32_t bfr[4][4];                        // the A fragments of sᵀ
  score_a(bfr, bra, brb, N, tq);
  // x_j (not dt·x_j: dMᵀ = dt_j ⊙ (x_j dy_iᵀ), so the A operand is bf16,
  // exact in TF32, and the product takes two terms): rows ja, jb, columns
  // p = 8ks + tq and p + 4 packed in one register
  uint32_t xfr[8][2];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r ? jb : ja, p = 8 * ks + tq;
      const uint32_t lo = (j < Q && p < P) ? bf16_bits(xb + j * xs.q + p) : 0u;
      const uint32_t hi16 =
          (j < Q && p + 4 < P) ? bf16_bits(xb + j * xs.q + p + 4) : 0u;
      xfr[ks][r] = lo | (hi16 << 16);
    }
  const float dta = dts[ja], dtb = dts[jb];

  // ---- the state terms: dd = w ⊙ (B_j dS) and db = w ⊙ u, u = dt_j ⊙
  // (x_j dSᵀ), each a bf16 operand (exact in TF32) against dS split (two
  // products); dw_j = B_j · u_j
  cp_async_wait<0>();
  __syncthreads();
  float dd[8][4], db[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dd[a][c] = db[a][c] = 0.f;
  // a k-step at a time (not unrolled, so that no load is hoisted across
  // steps: the A fragments come from global memory, not from bfr and xfr)
#pragma unroll 1
  for (int ks = 0; ks < 8; ++ks) {
    // B_j dS, k = n in the order (0,2,4,6 | 1,3,5,7): the A fragment is
    // B_j's bf16 pairs (n, n + 1), widened
    uint32_t a[4];
    {
      const int n0 = 8 * ks + 2 * tq;
      pair_to_a(n0 < N ? u32_at(bra + n0) : 0u,
                n0 < N ? u32_at(brb + n0) : 0u, a);
    }
    const float* d0 = Ds + (8 * ks + 2 * tq) * kLdF + g;
#pragma unroll
    for (int pq = 0; pq < 8; pq += 4) {
      uint32_t hv[4][2], lv[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split_tf32(d0[8 * (pq + q)], hv[q][0], lv[q][0]);
        split_tf32(d0[kLdF + 8 * (pq + q)], hv[q][1], lv[q][1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_tf32(dd[pq + q], a, hv[q][0], hv[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_tf32(dd[pq + q], a, lv[q][0], lv[q][1]);
    }
    // x_j dSᵀ, k = p: x_j's columns p = 8ks + tq and p + 4
    {
      const int p = 8 * ks + tq;
      a[0] = ja < Q && p < P ? bf16_bits(xb + ja * xs.q + p) << 16 : 0u;
      a[1] = jb < Q && p < P ? bf16_bits(xb + jb * xs.q + p) << 16 : 0u;
      a[2] = ja < Q && p + 4 < P ? bf16_bits(xb + ja * xs.q + p + 4) << 16
                                 : 0u;
      a[3] = jb < Q && p + 4 < P ? bf16_bits(xb + jb * xs.q + p + 4) << 16
                                 : 0u;
    }
    d0 = Ds + g * kLdF + 8 * ks + tq;
#pragma unroll
    for (int nq = 0; nq < 8; nq += 4) {
      uint32_t hv[4][2], lv[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split_tf32(d0[8 * (nq + q) * kLdF], hv[q][0], lv[q][0]);
        split_tf32(d0[8 * (nq + q) * kLdF + 4], hv[q][1], lv[q][1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_tf32(db[nq + q], a, hv[q][0], hv[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_tf32(db[nq + q], a, lv[q][0], lv[q][1]);
    }
  }
  __syncthreads();                                   // dS's place is free
  if (n > 1) issue(1, tile + 1);
  cp_async_commit();
  const float csl = css[Qp - 1], csa = css[ja], csb = css[jb];
  const float wa = ja < Q ? expf(csl - csa) : 0.f;
  const float wb = jb < Q ? expf(csl - csb) : 0.f;
  float dwa = 0.f, dwb = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const uint32_t ra = bfr[nt >> 1][2 * (nt & 1)],
                   rb = bfr[nt >> 1][2 * (nt & 1) + 1];
    db[nt][0] *= dta; db[nt][1] *= dta; db[nt][2] *= dtb; db[nt][3] *= dtb;
    dwa += __uint_as_float(ra << 16) * db[nt][0] +
           __uint_as_float(ra & 0xffff0000u) * db[nt][1];
    dwb += __uint_as_float(rb << 16) * db[nt][2] +
           __uint_as_float(rb & 0xffff0000u) * db[nt][3];
  }
  dwa = quad_sum(dwa);
  dwb = quad_sum(dwb);
  if (tq == 0) {
    if (ja < Q) pb[2 * Q + ja] = dwa * wa;
    if (jb < Q) pb[2 * Q + jb] = dwb * wb;
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    dd[a][0] *= wa; dd[a][1] *= wa; dd[a][2] *= wb; dd[a][3] *= wb;
    db[a][0] *= wa; db[a][1] *= wa; db[a][2] *= wb; db[a][3] *= wb;
  }

  // ---- the query tiles i >= j, 16 x 16 units (I, J) with I >= J
  const int J = 4 * tile + warp;
  const int lrow = lane & 7, lmat = lane >> 3;       // this lane's ldmatrix row
  float cola = 0.f, colb = 0.f;                      // G's column sums
  for (int k = 0; k < n; ++k) {
    cp_async_wait<1>();
    __syncthreads();
    // dy_i split into TF32 halves once per element as its stage lands: hi
    // to its own buffer, lo over dy_i
    float* Yt = Yst(k & 1);
    for (int e = t; e < kT * kT; e += kMmaThreads) {
      const int o = (e / kT) * kLdF + e % kT;
      uint32_t hv, lv;
      split_tf32(Yt[o], hv, lv);
      Hi[o] = hv;
      Yt[o] = __uint_as_float(lv);
    }
    __syncthreads();
    const uint32_t* Lo = reinterpret_cast<const uint32_t*>(Yt);
    const __nv_bfloat16* Ct = Cst(k & 1);
    const int it = tile + k;
#pragma unroll 1
    for (int u = 0; u < 4; ++u) {
      const int I = 4 * it + u;
      if (!live || I < J || 16 * I >= Q) continue;
      const int r16 = 16 * u;                        // the unit's stage rows
      float sc[2][4], dm[2][4];
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[c2][e] = dm[c2][e] = 0.f;
      // sᵀ = B_j C_iᵀ, bf16: C_i's B fragments by ldmatrix (matrix m of a
      // load: columns 16kh + 8m, so k16 steps kh and kh + 1)
      {
        uint32_t cf[2][2][4];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
            ldsm_x4(cf[c2][kh], Ct + (r16 + 8 * c2 + lrow) * kLdK + 32 * kh +
                                    8 * lmat);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
            mma_bf16(sc[c2], bfr[kk], cf[c2][kk >> 1][2 * (kk & 1)],
                     cf[c2][kk >> 1][2 * (kk & 1) + 1]);
      }
      // x_j dy_iᵀ = x·hi + x·lo; dy's hi and lo B fragments by one
      // ldmatrix (matrices: hi columns 8ks.., 8ks + 4.., lo the same)
      const uint32_t* yrow = ((lmat & 2) ? Lo : Hi) +
                             (r16 + lrow) * kLdF + 4 * (lmat & 1);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t a[4], yv[2][4];
        pair_to_a(xfr[ks][0], xfr[ks][1], a);
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
          ldsm_x4(yv[c2], yrow + 8 * c2 * kLdF + 8 * ks);
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) mma_tf32(dm[c2], a, yv[c2][0], yv[c2][1]);
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) mma_tf32(dm[c2], a, yv[c2][2], yv[c2][3]);
      }
      // per 8-query step c2: dMᵀ = dt_j ⊙ (x_j dy_iᵀ); mask first, then L =
      // exp(cs_i - cs_j); Mᵀ = sᵀ ⊙ L and dscᵀ = dMᵀ ⊙ L as A fragments
      // (k = the step's queries: k-slot tq is query row 2tq of the step,
      // tq + 4 row 2tq + 1); G = dM ⊙ M below the diagonal into the column
      // sums; then d(dtx)_j += Mᵀ dy_i (three products) and dB_j += dscᵀ
      // C_i (two)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int i0 = 16 * I + 8 * c2 + 2 * tq;
        const float ci[2] = {css[i0], css[i0 + 1]};
        float mv[4], dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? ja : jb, i = i0 + (e & 1);
          const float L = expf(i >= j ? ci[e & 1] - (e < 2 ? csa : csb)
                                      : -CUDART_INF_F);
          const float d = dm[c2][e] * (e < 2 ? dta : dtb);
          mv[e] = sc[c2][e] * L;
          dv[e] = d * L;
          if (i > j) {
            if (e < 2) cola += d * mv[e];
            else colb += d * mv[e];
          }
        }
        uint32_t mh[4], ml[4], dh[4], dl[4];
        acc_to_a(mv, mh, ml);
        acc_to_a(dv, dh, dl);
        const int r0 = r16 + 8 * c2 + 2 * tq;
#pragma unroll
        for (int pq = 0; pq < 8; pq += 2) {
          uint32_t hv[2][2], lv[2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int o = r0 * kLdF + 8 * (pq + q) + g;
            hv[q][0] = Hi[o];
            hv[q][1] = Hi[o + kLdF];
            lv[q][0] = Lo[o];
            lv[q][1] = Lo[o + kLdF];
          }
#pragma unroll
          for (int q = 0; q < 2; ++q)
            mma_tf32(dd[pq + q], mh, hv[q][0], hv[q][1]);
#pragma unroll
          for (int q = 0; q < 2; ++q)
            mma_tf32(dd[pq + q], mh, lv[q][0], lv[q][1]);
#pragma unroll
          for (int q = 0; q < 2; ++q)
            mma_tf32(dd[pq + q], ml, hv[q][0], hv[q][1]);
        }
        // C_i's columns as TF32 B fragments (k = queries): ldmatrix.trans
        // gives rows 2tq and 2tq + 1 of column g as one bf16 pair
#pragma unroll
        for (int nq = 0; nq < 8; nq += 4) {
          uint32_t cv[4];
          ldsm_x4_t(cv, Ct + (r16 + 8 * c2 + lrow) * kLdK + 8 * (nq + lmat));
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(db[nq + q], dh, cv[q] << 16, cv[q] & 0xffff0000u);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(db[nq + q], dl, cv[q] << 16, cv[q] & 0xffff0000u);
        }
      }
    }
    __syncthreads();
    if (k + 2 < n) issue(k & 1, tile + k + 2);
    cp_async_commit();
  }

  // ---- G's column sums, dx = dt_j d(dtx)_j, ddt_j = x_j · d(dtx)_j, dB_j
  cola = quad_sum(cola);
  colb = quad_sum(colb);
  if (tq == 0) {
    if (ja < Q) pb[Q + ja] = cola;
    if (jb < Q) pb[Q + jb] = colb;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? jb : ja;
    const bool in = j < Q;
    const long long q = in ? j : 0;
    const float dtj = half ? dtb : dta;
    float gsum = 0.f;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const int p = 8 * pt + 2 * tq;
      const float v0 = dd[pt][2 * half], v1 = dd[pt][2 * half + 1];
      if (in && p < P) {
        const uint32_t xv = u32_at(xb + q * xs.q + p);
        gsum += __uint_as_float(xv << 16) * v0 +
                __uint_as_float(xv & 0xffff0000u) * v1;
        store_bf16x2(dx + (cell + q * H) * P + p, dtj * v0, dtj * v1);
      }
    }
    gsum = quad_sum(gsum);
    if (tq == 0 && in) ddt[cell + q * H] = gsum;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * tq;
      if (in && c < N)
        store_bf16x2(dB + (cell + q * H) * N + c, db[nt][2 * half],
                     db[nt][2 * half + 1]);
    }
  }
}

// ---- query role: queries i0..i0+63, a warp's stripe iw..iw+15 (rows ia =
// iw + g and ib = ia + 8); walks the key tiles j <= i
__global__ void __launch_bounds__(kMmaThreads, 2)
ssd_bwd_queries_mma(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt,
                    const __nv_bfloat16* __restrict__ B,
                    const __nv_bfloat16* __restrict__ C,
                    const float* __restrict__ dA,
                    const float* __restrict__ dy,
                    __nv_bfloat16* __restrict__ dC, float* __restrict__ part,
                    int nc, int Q, int H, int P, int N, Strides xs,
                    Strides dts_, Strides Bs, Strides Cs, Strides dAs) {
  extern __shared__ float4 smem_v[];
  char* sm = reinterpret_cast<char*>(smem_v);
  const int nT = (Q + kT - 1) / kT, Qp = nT * kT;
  const BwdLayout lay(Qp, false);
  float* css = reinterpret_cast<float*>(sm + lay.cs);
  float* dts = reinterpret_cast<float*>(sm + lay.dt);
  double* wsum = reinterpret_cast<double*>(sm + lay.wsum);

  const int h = blockIdx.x, bz = blockIdx.y;
  const int tile = nT - 1 - blockIdx.z;          // the last tile first: it
  const int bi = bz / nc, ci = bz % nc;          // walks the most key tiles
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* xb = x + bi * xs.b + ci * xs.c + h * xs.h;
  const __nv_bfloat16* Bb = B + bi * Bs.b + ci * Bs.c + h * Bs.h;
  const __nv_bfloat16* Cb = C + bi * Cs.b + ci * Cs.c + h * Cs.h;
  const long long row = (long long)H * P;
  const long long cell = (long long)bz * Q * H + h;
  const float* dyb = dy + cell * P;
  float* pb = part + ((long long)bz * H + h) * kParts * Q;
  const int n = tile + 1;                        // key tiles to walk

  auto Bst = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(sm + s * lay.stage + lay.a);
  };
  auto Xst = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(sm + s * lay.stage + lay.b);
  };
  auto issue = [&](int s, int jt) {
    issue_tile(Bst(s), kLdK, Bb, Bs.q, N, jt, Q);
    issue_tile(Xst(s), kLdK, xb, xs.q, P, jt, Q);
  };
  for (int s = 0; s < 2; ++s) {
    zero_cols(Bst(s), kLdK, N);
    zero_cols(Xst(s), kLdK, P);
  }
  issue(0, 0);
  cp_async_commit();
  if (n > 1) issue(1, 1);
  cp_async_commit();
  scan_cs(dA + bi * dAs.b + ci * dAs.c + h * dAs.h, dAs.q,
          dt + bi * dts_.b + ci * dts_.c + h * dts_.h, dts_.q, Q, Qp, css,
          dts, wsum);

  const int iw = tile * kT + 16 * warp, ia = iw + g, ib = ia + 8;
  const bool live = iw < Q;
  // C_i's rows (a row past the chunk reads the last one: it only feeds its
  // own row of the products, which is not written)
  const __nv_bfloat16* cra = Cb + min(ia, Q - 1) * Cs.q;
  const __nv_bfloat16* crb = Cb + min(ib, Q - 1) * Cs.q;
  uint32_t cfr[4][4];                        // the A fragments of s
  score_a(cfr, cra, crb, N, tq);
  // dy_i in TF32 halves: the A fragments of dy_i x_jᵀ (k = p, in the order
  // (0,2,4,6 | 1,3,5,7) of a step, so x_j's B fragment is one bf16 pair)
  uint32_t yh[8][4], yl[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = (r & 1) ? ib : ia, p = 8 * ks + 2 * tq + (r >> 1);
      split_tf32((i < Q && p < P) ? dyb[i * row + p] : 0.f, yh[ks][r],
                 yl[ks][r]);
    }
  const float csa = css[ia], csb = css[ib];

  const int I = 4 * tile + warp;
  const int lrow = lane & 7, lmat = lane >> 3;   // this lane's ldmatrix row
  float dc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dc[a][c] = 0.f;
  float rowa = 0.f, rowb = 0.f;                  // G's row sums
  for (int k = 0; k < n; ++k) {
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Bt = Bst(k & 1);
    const __nv_bfloat16* Xt = Xst(k & 1);
#pragma unroll 1
    for (int v = 0; v < 4; ++v) {
      const int Jn = 4 * k + v;
      if (!live || Jn > I || 16 * Jn >= Q) continue;
      const int r16 = 16 * v;
      float s[2][4], dm[2][4];
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c2][e] = dm[c2][e] = 0.f;
      // s = C_i B_jᵀ, bf16: B_j's B fragments by ldmatrix
      {
        uint32_t bf[2][2][4];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
            ldsm_x4(bf[c2][kh], Bt + (r16 + 8 * c2 + lrow) * kLdK + 32 * kh +
                                    8 * lmat);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
            mma_bf16(s[c2], cfr[kk], bf[c2][kk >> 1][2 * (kk & 1)],
                     bf[c2][kk >> 1][2 * (kk & 1) + 1]);
      }
      // dy_i x_jᵀ = hi·x + lo·x (x exact in TF32); x_j's pairs by
      // ldmatrix (matrix m of a load: columns 8(kq + m))
#pragma unroll
      for (int kq = 0; kq < 8; kq += 4) {
        uint32_t xv[2][4];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
          ldsm_x4(xv[c2], Xt + (r16 + 8 * c2 + lrow) * kLdK + 8 * (kq + lmat));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
            mma_tf32(dm[c2], yh[kq + q], xv[c2][q] << 16,
                     xv[c2][q] & 0xffff0000u);
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
            mma_tf32(dm[c2], yl[kq + q], xv[c2][q] << 16,
                     xv[c2][q] & 0xffff0000u);
        }
      }
      // per 8-key step c2: dM = (dy_i x_jᵀ) ⊙ dt_j; mask first, then L;
      // dsc = dM ⊙ L as an A fragment (k-slot tq is key row 2tq of the
      // step, tq + 4 row 2tq + 1); G = dM ⊙ s ⊙ L below the diagonal into
      // the row sums; then dC_i += dsc B_j (two products)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int j0 = 16 * Jn + 8 * c2 + 2 * tq;
        const float cj[2] = {css[j0], css[j0 + 1]};
        const float tj[2] = {dts[j0], dts[j0 + 1]};
        float dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, j = j0 + (e & 1);
          const float L = expf(j <= i ? (e < 2 ? csa : csb) - cj[e & 1]
                                      : -CUDART_INF_F);
          const float d = dm[c2][e] * tj[e & 1];
          dv[e] = d * L;
          if (j < i) {
            if (e < 2) rowa += d * (s[c2][e] * L);
            else rowb += d * (s[c2][e] * L);
          }
        }
        uint32_t dh[4], dl[4];
        acc_to_a(dv, dh, dl);
        // B_j's columns as TF32 B fragments (k = keys) by ldmatrix.trans
#pragma unroll
        for (int nq = 0; nq < 8; nq += 4) {
          uint32_t bv[4];
          ldsm_x4_t(bv, Bt + (r16 + 8 * c2 + lrow) * kLdK + 8 * (nq + lmat));
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(dc[nq + q], dh, bv[q] << 16, bv[q] & 0xffff0000u);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(dc[nq + q], dl, bv[q] << 16, bv[q] & 0xffff0000u);
        }
      }
    }
    __syncthreads();
    if (k + 2 < n) issue(k & 1, k + 2);
    cp_async_commit();
  }

  rowa = quad_sum(rowa);
  rowb = quad_sum(rowb);
  if (tq == 0) {
    if (ia < Q) pb[ia] = rowa;
    if (ib < Q) pb[ib] = rowb;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? ib : ia;
    if (i >= Q) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * tq;
      if (c < N)
        store_bf16x2(dC + (cell + (long long)i * H) * N + c, dc[nt][2 * half],
                     dc[nt][2 * half + 1]);
    }
  }
}

template <typename F>
cudaError_t smem_attr(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

enum KernelId { kTiles = 0, kMma = 1 };   // ssd_chunk_bwd.py KERNEL_IDS

template <typename T>
cudaError_t launch_tiles(const void* x, const void* dt, const void* B,
                         const void* C, const void* dA, const void* dy,
                         const void* dS, void* dx, void* ddt, void* dB,
                         void* dC, void* part, int b, int nc, int Q, int H,
                         int P, int N, Strides xs, Strides dts, Strides Bs,
                         Strides Cs, Strides dAs, cudaStream_t stream) {
  static const cudaError_t attr = smem_attr(ssd_bwd_tiles<T>, (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const int nT = (Q + kT - 1) / kT;
  ssd_bwd_tiles<T><<<dim3(H, b * nc, 2 * nT), kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(dA), static_cast<const float*>(dy),
      static_cast<const float*>(dS), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(part), nc, Q, H, P, N, xs, dts, Bs, Cs, dAs);
  return cudaGetLastError();
}

// the two role kernels in turn (keys, then queries); each block's shared
// memory is BwdLayout's total at this Q
cudaError_t launch_mma(const void* x, const void* dt, const void* B,
                       const void* C, const void* dA, const void* dy,
                       const void* dS, void* dx, void* ddt, void* dB,
                       void* dC, void* part, int b, int nc, int Q, int H,
                       int P, int N, Strides xs, Strides dts, Strides Bs,
                       Strides Cs, Strides dAs, cudaStream_t stream) {
  if (P % 8 || N % 8) return cudaErrorInvalidValue;
  static const cudaError_t attr = [] {
    const cudaError_t e = smem_attr(ssd_bwd_keys_mma,
                                    BwdLayout(kMaxQ, true).total);
    return e != cudaSuccess ? e
                            : smem_attr(ssd_bwd_queries_mma,
                                        BwdLayout(kMaxQ, false).total);
  }();
  if (attr != cudaSuccess) return attr;
  using bf = __nv_bfloat16;
  const int nT = (Q + kT - 1) / kT;
  const dim3 grid(H, b * nc, nT);
  ssd_bwd_keys_mma<<<grid, kMmaThreads, BwdLayout(nT * kT, true).total,
                     stream>>>(
      static_cast<const bf*>(x), static_cast<const float*>(dt),
      static_cast<const bf*>(B), static_cast<const bf*>(C),
      static_cast<const float*>(dA), static_cast<const float*>(dy),
      static_cast<const float*>(dS), static_cast<bf*>(dx),
      static_cast<float*>(ddt), static_cast<bf*>(dB),
      static_cast<float*>(part), nc, Q, H, P, N, xs, dts, Bs, Cs, dAs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_queries_mma<<<grid, kMmaThreads, BwdLayout(nT * kT, false).total,
                        stream>>>(
      static_cast<const bf*>(x), static_cast<const float*>(dt),
      static_cast<const bf*>(B), static_cast<const bf*>(C),
      static_cast<const float*>(dA), static_cast<const float*>(dy),
      static_cast<bf*>(dC), static_cast<float*>(part), nc, Q, H, P, N, xs,
      dts, Bs, Cs, dAs);
  return cudaGetLastError();
}

}  // namespace

// x (b,nc,Q,H,P), B/C (b,nc,Q,H,N) in `dtype`, unit stride on the last
// axis, read through the element strides of their (b, c, q, h) axes (a
// stride-0 head axis broadcasts B/C from one group); dt/dA (b,nc,Q,H) f32
// likewise; dy (b,nc,Q,H,P) and dS (b,nc,H,N,P) contiguous f32.  Writes
// contiguous dx (b,nc,Q,H,P), dB and dC (b,nc,Q,H,N) in `dtype`, ddt and
// ddA (b,nc,Q,H) f32; `part` is f32 scratch of b·nc·H·3·Q.  `kernel` is
// the plan's route (KernelId): kMma takes bf16 with P and N multiples of 8
// and rows of x, B and C that start on 16 bytes (its 16-byte copies).
extern "C" int repro_ssd_chunk_bwd(
    const void* x, const void* dt, const void* B, const void* C,
    const void* dA, const void* dy, const void* dS, void* dx, void* ddt,
    void* dB, void* dC, void* ddA, void* part, int dtype, int kernel, int b,
    int nc, int Q, int H, int P, int N,
    long long xsb, long long xsc, long long xsq, long long xsh,
    long long dtsb, long long dtsc, long long dtsq, long long dtsh,
    long long Bsb, long long Bsc, long long Bsq, long long Bsh,
    long long Csb, long long Csc, long long Csq, long long Csh,
    long long dAsb, long long dAsc, long long dAsq, long long dAsh,
    void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kT || N < 1 || N > kT || b < 1 ||
      nc < 1 || H < 1)
    return cudaErrorInvalidValue;
  const Strides xs{xsb, xsc, xsq, xsh}, dts{dtsb, dtsc, dtsq, dtsh},
      Bs{Bsb, Bsc, Bsq, Bsh}, Cs{Csb, Csc, Csq, Csh},
      dAs{dAsb, dAsc, dAsq, dAsh};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == kMma && dtype == repro::kBF16)
    err = launch_mma(x, dt, B, C, dA, dy, dS, dx, ddt, dB, dC, part, b, nc,
                     Q, H, P, N, xs, dts, Bs, Cs, dAs, st);
  else if (kernel == kTiles && dtype == repro::kF32)
    err = launch_tiles<float>(x, dt, B, C, dA, dy, dS, dx, ddt, dB, dC,
                              part, b, nc, Q, H, P, N, xs, dts, Bs, Cs, dAs,
                              st);
  else if (kernel == kTiles && dtype == repro::kBF16)
    err = launch_tiles<__nv_bfloat16>(x, dt, B, C, dA, dy, dS, dx, ddt, dB,
                                      dC, part, b, nc, Q, H, P, N, xs, dts,
                                      Bs, Cs, dAs, st);
  if (err != cudaSuccess) return err;
  ssd_bwd_finish<<<dim3(H, b * nc), kThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(ddA), Q, H);
  return cudaGetLastError();
}
