// K5 — Mamba2 SSD intra-chunk term.
//
// Replaces the TPU kernel repro/kernels/mamba2_scan.py::_ssd_kernel
// (pallas_call at mamba2_scan.py:61).  For each (batch, chunk, head):
//
//   y[i] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (Q x P)
//   S    = sum_j B_j (x) exp(cs_last - cs_j) dt_j x_j           (N x P)
//
// with cs = cumsum(dA) over the chunk.  Inputs x, B, C in f32 or bf16,
// dt and dA in f32; y and S come out in f32.
//
// What bounds it on the H100: operations.  At zamba2's widths (Q = 256,
// P = N = 64) a cell does Q(Q+1)/2 N multiply-adds for the scores C·Bᵀ,
// on operands of the input type with f32 sums (exact, so bf16 inputs
// could take the bf16 tensor cores), and Q(Q+1)/2 P + Q N P on f32
// operands (the masked scores, dt·x and the decayed B are f32 whatever
// the input type), against about 100 KB of input and output, so it sits
// above the bytes line, mostly on the card's f32 CUDA-core rate.
//
// Design.  The TPU kernel holds a whole cell, with its Q x Q mask, in one
// VMEM tile; at Q = 256 the f32 mask-times-scores tile alone is 256 KB,
// above the 227 KB a Hopper block can have.  So the port tiles: one block
// per (64-query row tile, head, batch x chunk), plus one more block per
// (head, batch x chunk) for the chunk state S.  A row tile walks the key
// tiles up to its last row only (causal), forms the 64 x 64 scores in
// shared memory, masks them BEFORE exp (exp(cs_i - cs_j) is formed only
// where i >= j, where the exponent is <= 0), and accumulates (scores ⊙ L)
// · (dt·x) in registers, a 4 x 4 micro-tile per thread.  Every block first
// forms cs with a scan in f64, rounded once to f32, as the plain version
// does (kernels/ref.py chunk_cumsum): at zamba2's decays cs reaches about
// -3000, where f32 sums in different orders differ by 2.4e-4.
//
// B and C are read through their strides, so the caller passes a stride-0
// view broadcast from one group to every head (no copy per head), as K1
// reads the KV cache in place.  P and N are at most 64 (zero-padded in
// shared memory); Q is 1 to 256.  CUDA-core f32 FMAs: wgmma/TMA are later
// work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // query rows, keys per tile, padded P and N
constexpr int kLd = kT + 1;   // shared-memory row stride (no bank conflicts)
constexpr int kMaxQ = 256;    // one scan element per thread

constexpr size_t kSmem =
    kMaxQ * sizeof(double) + kMaxQ * sizeof(float) + 4 * kT * kLd * sizeof(float);

struct Strides {
  long long b, c, q, h;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_fwd(const T* __restrict__ x, const float* __restrict__ dt,
              const T* __restrict__ B, const T* __restrict__ C,
              const float* __restrict__ dA, float* __restrict__ y,
              float* __restrict__ S, int nc, int Q, int H, int P, int N,
              Strides xs, Strides dts, Strides Bs, Strides Cs, Strides dAs) {
  extern __shared__ double smem_d[];
  double* scan = smem_d;                                     // [kMaxQ]
  float* cs = reinterpret_cast<float*>(scan + kMaxQ);        // [kMaxQ]
  float* Ct = cs + kMaxQ;                                    // [kT][kLd]
  float* Bt = Ct + kT * kLd;                                 // [kT][kLd]
  float* Xt = Bt + kT * kLd;                                 // [kT][kLd]
  float* St = Xt + kT * kLd;                                 // [kT][kLd]

  const int tile = blockIdx.x, h = blockIdx.y;
  const int bi = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int n_row_tiles = (Q + kT - 1) / kT;

  const T* xb = x + bi * xs.b + ci * xs.c + h * xs.h;
  const float* dtb = dt + bi * dts.b + ci * dts.c + h * dts.h;
  const T* Bb = B + bi * Bs.b + ci * Bs.c + h * Bs.h;
  const T* Cb = C + bi * Cs.b + ci * Cs.c + h * Cs.h;
  const float* dAb = dA + bi * dAs.b + ci * dAs.c + h * dAs.h;

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

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  if (tile == n_row_tiles) {
    // ---- chunk state: S[n][p] = sum_q B[q][n] exp(cs_last - cs_q) dtx[q][p]
    const float cs_last = cs[Q - 1];
    for (int q0 = 0; q0 < Q; q0 += kT) {
      __syncthreads();
      for (int e = t; e < kT * kT; e += kThreads) {
        const int r = e / kT, c = e % kT, q = q0 + r;
        float bv = 0.f, xv = 0.f;
        if (q < Q) {
          if (c < N) bv = repro::to_f(Bb[q * Bs.q + c]) * expf(cs_last - cs[q]);
          if (c < P) xv = repro::to_f(xb[q * xs.q + c]) * dtb[q * dts.q];
        }
        Bt[r * kLd + c] = bv;
        Xt[r * kLd + c] = xv;
      }
      __syncthreads();
      for (int r = 0; r < kT; ++r) {
        float bn[4], xp[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bn[a] = Bt[r * kLd + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) xp[c] = Xt[r * kLd + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += bn[a] * xp[c];
      }
    }
    float* Sb = S + (((long long)bi * nc + ci) * H + h) * N * P;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (n < N && p < P) Sb[n * P + p] = acc[a][c];
      }
    }
    return;
  }

  // ---- intra-chunk output for query rows [i0, i0 + kT)
  const int i0 = tile * kT;
  for (int e = t; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    Ct[r * kLd + c] =
        (i0 + r < Q && c < N) ? repro::to_f(Cb[(i0 + r) * Cs.q + c]) : 0.f;
  }
  const int kend = min(Q, i0 + kT);  // keys past the tile's last row are masked
  for (int j0 = 0; j0 < kend; j0 += kT) {
    __syncthreads();
    for (int e = t; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT, j = j0 + r;
      float bv = 0.f, xv = 0.f;
      if (j < Q) {
        if (c < N) bv = repro::to_f(Bb[j * Bs.q + c]);
        if (c < P) xv = repro::to_f(xb[j * xs.q + c]) * dtb[j * dts.q];
      }
      Bt[r * kLd + c] = bv;
      Xt[r * kLd + c] = xv;
    }
    __syncthreads();
    // scores of rows ty + 16a against keys tx + 16c, masked, times L
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cn[4], bn[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cn[a] = Ct[(ty + 16 * a) * kLd + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) bn[c] = Bt[(tx + 16 * c) * kLd + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += cn[a] * bn[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        // mask first: exp only of cs_i - cs_j <= 0
        const float L = (i < Q && j <= i) ? expf(cs[i] - cs[j]) : 0.f;
        St[(ty + 16 * a) * kLd + tx + 16 * c] = s[a][c] * L;
      }
    }
    __syncthreads();
    const int jn = min(kT, kend - j0);
    for (int r = 0; r < jn; ++r) {
      float sr[4], xp[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sr[a] = St[(ty + 16 * a) * kLd + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) xp[c] = Xt[r * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += sr[a] * xp[c];
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= Q) continue;
    float* yr = y + ((((long long)bi * nc + ci) * Q + i) * H + h) * P;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      if (p < P) yr[p] = acc[a][c];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* B, const void* C,
           const void* dA, void* y, void* S, int b, int nc, int Q, int H,
           int P, int N, Strides xs, Strides dts, Strides Bs, Strides Cs,
           Strides dAs, cudaStream_t stream) {
  // once per instantiation (a thread-safe static), not on every launch:
  // decode launches K5 once per layer per token
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Q + kT - 1) / kT + 1, H, b * nc);
  ssd_chunk_fwd<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(dA), static_cast<float*>(y),
      static_cast<float*>(S), nc, Q, H, P, N, xs, dts, Bs, Cs, dAs);
  return cudaGetLastError();
}

}  // namespace

// x (b,nc,Q,H,P), B/C (b,nc,Q,H,N) in `dtype`, unit stride on the last
// axis; dt/dA (b,nc,Q,H) f32.  Element strides of the (b, c, q, h) axes
// for each input (a stride-0 head axis broadcasts B/C from one group).
// y (b,nc,Q,H,P) and S (b,nc,H,N,P) contiguous f32.
extern "C" int repro_ssd_chunk(
    const void* x, const void* dt, const void* B, const void* C,
    const void* dA, void* y, void* S, int dtype, int b, int nc, int Q,
    int H, int P, int N, long long xsb, long long xsc, long long xsq,
    long long xsh, long long dtsb, long long dtsc, long long dtsq,
    long long dtsh, long long Bsb, long long Bsc, long long Bsq,
    long long Bsh, long long Csb, long long Csc, long long Csq,
    long long Csh, long long dAsb, long long dAsc, long long dAsq,
    long long dAsh, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kT || N < 1 || N > kT)
    return cudaErrorInvalidValue;
  const Strides xs{xsb, xsc, xsq, xsh}, dts{dtsb, dtsc, dtsq, dtsh},
      Bs{Bsb, Bsc, Bsq, Bsh}, Cs{Csb, Csc, Csq, Csh},
      dAs{dAsb, dAsc, dAsq, dAsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N, xs, dts,
                         Bs, Cs, dAs, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N,
                                 xs, dts, Bs, Cs, dAs, st);
  return cudaErrorInvalidValue;
}
