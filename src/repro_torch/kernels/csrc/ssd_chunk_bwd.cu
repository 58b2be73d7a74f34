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
// about 25 MFLOP a cell, 12.9 GFLOP a launch: operations, 78 us at f32
// accuracy on the TF32 tensor cores split three ways (165 TFLOP/s), 193 us
// at the CUDA cores' 67 TFLOP/s; the bytes (about 112 MB in bf16, the
// per-head dB and dC included) take 33 us.  This first version computes
// in f32 on the CUDA cores (dy and dS are f32, so every product with them
// needs f32 accuracy, and bf16 rounding of an f32 operand would not hold
// it).  Two kernels:
//
// * ssd_bwd_tiles<T>: a block of 256 threads per (head, batch x chunk,
//   role tile), 64 x 64 tiles, i >= j, each thread a 4 x 4 patch.  A
//   key-tile block owns keys j0..j0+63 (B_j and dtx_j resident): it adds
//   the state terms, then walks the query tiles i >= j, recomputing s, dM
//   and L, and accumulates d(dtx)_j, dB_j and G's column sums; it writes
//   dx, ddt, dB.  A query-tile block owns rows i0..i0+63 (C_i and dy_i
//   resident): it walks the key tiles j <= i and accumulates dC_i and G's
//   row sums.  blockIdx.z interleaves the roles longest first.
// * ssd_bwd_finish: a block per (head, batch x chunk): the f64 scans of
//   the row and column sums and the w terms into ddA.
#include "common.cuh"

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

template <typename F>
cudaError_t smem_attr(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int launch(const void* x, const void* dt, const void* B, const void* C,
           const void* dA, const void* dy, const void* dS, void* dx,
           void* ddt, void* dB, void* dC, void* ddA, void* part, int b,
           int nc, int Q, int H, int P, int N, Strides xs, Strides dts,
           Strides Bs, Strides Cs, Strides dAs, cudaStream_t stream) {
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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_finish<<<dim3(H, b * nc), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(ddA), Q, H);
  return cudaGetLastError();
}

}  // namespace

// x (b,nc,Q,H,P), B/C (b,nc,Q,H,N) in `dtype`, unit stride on the last
// axis, read through the element strides of their (b, c, q, h) axes (a
// stride-0 head axis broadcasts B/C from one group); dt/dA (b,nc,Q,H) f32
// likewise; dy (b,nc,Q,H,P) and dS (b,nc,H,N,P) contiguous f32.  Writes
// contiguous dx (b,nc,Q,H,P), dB and dC (b,nc,Q,H,N) in `dtype`, ddt and
// ddA (b,nc,Q,H) f32; `part` is f32 scratch of b·nc·H·3·Q.
extern "C" int repro_ssd_chunk_bwd(
    const void* x, const void* dt, const void* B, const void* C,
    const void* dA, const void* dy, const void* dS, void* dx, void* ddt,
    void* dB, void* dC, void* ddA, void* part, int dtype, int b, int nc,
    int Q, int H, int P, int N,
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
  if (dtype == repro::kF32)
    return launch<float>(x, dt, B, C, dA, dy, dS, dx, ddt, dB, dC, ddA,
                         part, b, nc, Q, H, P, N, xs, dts, Bs, Cs, dAs, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, dt, B, C, dA, dy, dS, dx, ddt, dB, dC,
                                 ddA, part, b, nc, Q, H, P, N, xs, dts, Bs,
                                 Cs, dAs, st);
  return cudaErrorInvalidValue;
}
