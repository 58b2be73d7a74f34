// K5 — Mamba2 SSD intra-chunk term.
//
// Replaces the TPU kernel repro/kernels/mamba2_scan.py::_ssd_kernel
// (pallas_call at mamba2_scan.py:61).  For each (batch, chunk, head):
//
//   y[i] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (Q x P)
//   S    = sum_j B_j (x) exp(cs_last - cs_j) dt_j x_j           (N x P)
//
// with cs = cumsum(dA) over the chunk.  Inputs x, B, C in f32 or bf16,
// dt and dA in f32; y and S come out in f32.  Every kernel forms cs in f64
// and rounds it once to f32, as the plain version does (kernels/ref.py
// chunk_cumsum): at zamba2's decays cs reaches about -3000, where f32 sums
// in different orders differ by 2.4e-4.  Every kernel masks the exponent
// BEFORE exp (exp(-inf) = 0 above the diagonal), and reads B and C through
// their strides, so a stride-0 view broadcast from one group to every head
// costs no copy.
//
// What bounds it on the H100.  A decode step (Q = 1) moves about 1 MB, S,
// for zamba2's 64 heads of 64 x 64, and does almost no arithmetic: bytes,
// 0.32 us, far under the 4.7 us launch floor.  A 128-token chunk does
// Q(Q+1)/2 N multiply-adds for the scores C·Bᵀ (input type, f32 sums) and
// Q(Q+1)/2 P + Q N P on f32 operands per head: operations, about 2 us at
// the card's f32 rate.  Three kernels, chosen by ssd_chunk.py::plan:
//
// * ssd_decode<T> (Q <= 32; the engine's decode steps): a block per
//   (head, slice of S's rows, batch x chunk), so the writes of S spread
//   over every SM.  Lanes run on P and N with 16-byte loads, cs is
//   a warp-shuffle scan in f64, each score is a dot product of an 8-lane
//   group, and y and S leave as 16-byte stores.  No shared memory and no
//   block barrier: a decode step is latency, one round trip of loads and
//   one of stores after the launch.
//
// * ssd_chunk_mma (bf16, longer chunks): a block of 8 warps per (head,
//   slice of P, batch x chunk), the whole chunk held in shared memory; P is
//   sliced (the plan's choice) so that zamba2's 64 heads fill the SMs.  C,
//   B and x arrive by cp.async in 64-row stages, each signalled on its own
//   mbarrier; dt·x is split into TF32 halves once per element as its stage
//   lands, while later stages are still in flight.  The work is cut into
//   16-row units, y's row stripes and S's state-row stripes, dealt to the
//   warps longest first.  The scores C·Bᵀ run on the bf16 tensor cores
//   (mma.sync m16n8k16, exact products, f32 sums); the mask and
//   exp(cs_i - cs_j) are applied to the accumulator fragments in registers.
//   mma.sync rather than wgmma: a warp's 16-row stripe is the unit the
//   causal mask and the load balance need, where wgmma's 64-row warpgroup
//   tile would idle most of a diagonal tile.  The two products on f32
//   operands, (scores ⊙ L)·(dt·x) and (B ⊙ decay)ᵀ·(dt·x), run on the TF32
//   tensor cores with an error-compensated split: each operand is hi + lo,
//   both TF32, and a·b = hi·hi + hi·lo + lo·hi (the lo·lo term, 2^-22
//   relative, is dropped), which keeps f32 accuracy; one TF32 rounding (10
//   mantissa bits) would not hold 2e-4.  The score fragment feeds the next
//   product from registers: with the keys of an 8-key step taken in the
//   order (0,2,4,6 | 1,3,5,7), the m16n8 accumulator of the scores is
//   exactly the m16n8k8 A fragment.  S comes from the same block, which
//   already holds B and x.  A warp waits on each dependent mma.sync, so a
//   y stripe takes its keys 32 at a time, four independent score chains,
//   and keeps the correction terms in their own accumulators.
//
// * ssd_chunk_fwd<T> (f32 chunks, and any P or N not a multiple of 8): the
//   CUDA-core kernel of the port's first version, a block per (64-row query
//   tile, head, batch x chunk) plus one per (head, batch x chunk) for S.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::cp_async16;
using repro::mma_bf16;
using repro::mma_tf32;
using repro::split_tf32;
using repro::u32_at;

struct Strides {
  long long b, c, q, h;
};

// ---------------------------------------------------------------------------
// ssd_chunk_fwd: CUDA cores, 64-row tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kT = 64;        // query rows, keys per tile, padded P and N
constexpr int kLd = kT + 1;   // shared-memory row stride (no bank conflicts)
constexpr int kMaxQ = 256;    // one scan element per thread

constexpr size_t kSmem =
    kMaxQ * sizeof(double) + kMaxQ * sizeof(float) + 4 * kT * kLd * sizeof(float);

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

// ---------------------------------------------------------------------------
// ssd_decode: short chunks, lanes on P and N
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxQ = 32;      // one scan element per lane

// 16 bytes of T from global memory, widened to f32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; k += 4)
    *reinterpret_cast<float4*>(p + k) =
        make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// A block of 4 warps per (head, slice of S's rows, batch x chunk).  No
// shared memory and no block barrier: every warp scans the head's cs
// itself (lane q holds cs_q, dt_q and the decay to the chunk's end, handed
// to the other lanes by shuffles) and reads B, C and x straight from
// global memory, 16 bytes a lane.
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
ssd_decode(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ B, const T* __restrict__ C,
           const float* __restrict__ dA, float* __restrict__ y,
           float* __restrict__ S, int nc, int Q, int H, int P, int N,
           int splits, Strides xs, Strides dts, Strides Bs, Strides Cs,
           Strides dAs) {
  constexpr int V = Vec<T>::n;
  const unsigned all = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int h = blockIdx.x, split = blockIdx.y;
  const int bi = blockIdx.z / nc, ci = blockIdx.z % nc;
  const T* xh = x + bi * xs.b + ci * xs.c + h * xs.h;
  const T* Bh = B + bi * Bs.b + ci * Bs.c + h * Bs.h;
  const T* Ch = C + bi * Cs.b + ci * Cs.c + h * Cs.h;

  // ---- cs = cumsum(dA): a warp-shuffle scan in f64, rounded once.  A
  // one-token chunk needs none: its only decay is exp(0) = 1.
  const float dtq = lane < Q ? dt[bi * dts.b + ci * dts.c + lane * dts.q +
                                  h * dts.h]
                             : 0.f;
  float cs = 0.f, dec = 1.f;
  if (Q > 1) {
    double cum = lane < Q ? (double)dA[bi * dAs.b + ci * dAs.c +
                                       lane * dAs.q + h * dAs.h]
                          : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(all, cum, o);
      if (lane >= o) cum += u;
    }
    cs = (float)cum;
    dec = expf(__shfl_sync(all, cs, Q - 1) - cs);
  }
  const int pv = P / V;                    // lanes on a row of x, y or S

  // ---- y rows split, split + splits, ...: a row's scores C_i·B_j are dot
  // products of 8-lane groups (4 keys at a time), each masked before exp
  // and applied to dt_j x_j by the row's lanes.  In a block that has y
  // rows, the first warp takes them all and the other warps S, so the two
  // run side by side.
  const int yrows = split < Q ? (Q - 1 - split) / splits + 1 : 0;
  const int yw = yrows > 0 ? 1 : 0;        // warps the block gives to y
  const int grp = lane >> 3, l8 = lane & 7;
  for (int r = 0; warp == 0 && r < yrows; ++r) {
    const int i = split + r * splits;
    const float csi = __shfl_sync(all, cs, i);
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 <= i; j0 += 4) {
      // the x rows first: their loads overlap the dot products'
      float xv[4][V];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j0 + jj <= i && lane < pv)
          Vec<T>::load(xh + (j0 + jj) * xs.q + lane * V, xv[jj]);
      const int j = j0 + grp;
      float dot = 0.f;
      if (j <= i)
        for (int c = l8 * V; c < N; c += 8 * V) {
          float cv[V], bv[V];
          Vec<T>::load(Ch + i * Cs.q + c, cv);
          Vec<T>::load(Bh + j * Bs.q + c, bv);
#pragma unroll
          for (int k = 0; k < V; ++k) dot += cv[k] * bv[k];
        }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) dot += __shfl_xor_sync(all, dot, o);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jx = j0 + jj;
        const float dj = __shfl_sync(all, dot, 8 * jj);
        const float csj = __shfl_sync(all, cs, jx & 31);
        const float dtj = __shfl_sync(all, dtq, jx & 31);
        if (jx <= i && lane < pv) {
          const float w = dj * expf(csi - csj);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += w * (xv[jj][k] * dtj);
        }
      }
    }
    if (lane < pv)
      store_f32<V>(y + ((((long long)bi * nc + ci) * Q + i) * H + h) * P +
                       lane * V,
                   acc);
  }

  // ---- S rows [n0, n1): outer products, 16 bytes of x in, 16 or 32 of S
  // out, per lane and key
  const int ns = (N + splits - 1) / splits;
  const int n0 = min(N, split * ns), n1 = min(N, n0 + ns);
  const int items = (n1 - n0) * pv;
  float* Sh = S + (((long long)bi * nc + ci) * H + h) * N * P;
  for (int base = (warp - yw) * 32; warp >= yw && base < items;
       base += (kDecWarps - yw) * 32) {
    const int it = base + lane;
    const bool ok = it < items;
    const int n = n0 + (ok ? it / pv : 0), c = ok ? (it % pv) * V : 0;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int q = 0; q < Q; ++q) {
      // the loads first: they need neither the scan nor dt
      float b = 0.f, xv[V];
      if (ok) {
        b = repro::to_f(Bh[q * Bs.q + n]);
        Vec<T>::load(xh + q * xs.q + c, xv);
      }
      const float dq = __shfl_sync(all, dec, q);
      const float tq = __shfl_sync(all, dtq, q);
      if (ok) {
        const float bw = b * dq;
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += bw * (xv[k] * tq);
      }
    }
    if (ok) store_f32<V>(Sh + n * P + c, acc);
  }
}

// ---------------------------------------------------------------------------
// ssd_chunk_mma: bf16, tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;        // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kStage = 64;              // rows per cp.async stage

// Shared-memory layout of one ssd_chunk_mma block, in bytes, for a chunk of
// Qp rows (Q rounded up to 16), NP state columns and a slice of PS of x's
// P columns.  Row strides are padded so that the fragment reads of a warp
// fall in 32 distinct banks: C and B rows NP + 8 bf16, the TF32 halves of
// dt·x rows PS rounded up to 16, + 8 words.  ssd_chunk.py::mma_smem gives
// the same total: the plan keeps every launch within the card's limit.
struct MmaLayout {
  int ldk, ldx, ldh, c, b, x, hi, lo, dt, cs, dec, bar, wsum, total;
  __host__ __device__ MmaLayout(int Qp, int NP, int PS) {
    ldk = NP + 8;
    ldx = PS + 8;
    ldh = (PS + 15) / 16 * 16 + 8;
    c = 0;                                   // bf16 [Qp][ldk]  C
    b = c + Qp * ldk * 2;                    // bf16 [Qp][ldk]  B
    x = b + Qp * ldk * 2;                    // bf16 [Qp][ldx]  x, P slice
    hi = x + Qp * ldx * 2;                   // u32 [Qp][ldh]   dt·x, TF32 hi
    lo = hi + Qp * ldh * 4;                  // u32 [Qp][ldh]   and lo
    dt = lo + Qp * ldh * 4;                  // f32 [Qp]
    cs = dt + Qp * 4;                        // f32 [Qp]
    dec = cs + Qp * 4;                       // f32 [Qp]
    bar = dec + Qp * 4;                      // u64 [4] one per stage
    wsum = bar + 4 * 8;                      // f64 [warps + 1] the scan's
    total = wsum + (kMmaWarps + 1) * 8;      //   warp totals, its last
  }
};

// arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier counts one arrival per thread of the block)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(repro::smem_u32(bar)) : "memory");
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// rows q..q+64 of a (rows, 8 * chunks) bf16 tile by 16-byte cp.async, a
// thread on one chunk of every (threads / chunks)-th row
__device__ __forceinline__ void issue_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           long long stride, int chunks,
                                           int r0, int r1, int t) {
  const int per = kMmaThreads / chunks;
  if (t >= per * chunks) return;
  const int k = 8 * (t % chunks);
  for (int q = r0 + t / chunks; q < r1; q += per)
    cp_async16(dst + q * ld + k, src + q * stride + k);
}

// Where dt·x's row q sits in shared memory: within each group of 8 rows
// the even rows first (0,2,4,6 | 1,3,5,7), so a k-step's B fragment, which
// takes key j0 + 2tq at k-slot tq and j0 + 2tq + 1 at tq + 4 (the order
// the score accumulator hands over), reads rows j0 + tq and j0 + tq + 4.
__device__ __forceinline__ int dtx_row(int q) {
  return (q & ~7) | ((q & 1) << 2) | ((q & 7) >> 1);
}

template <int PT>   // 8-column tiles of this block's slice of P
__global__ void __launch_bounds__(kMmaThreads)
ssd_chunk_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
              const __nv_bfloat16* __restrict__ B,
              const __nv_bfloat16* __restrict__ C,
              const float* __restrict__ dA, float* __restrict__ y,
              float* __restrict__ S, int nc, int Q, int H, int P, int N,
              Strides xs, Strides dts, Strides Bs, Strides Cs, Strides dAs) {
  extern __shared__ float4 smem_v[];
  char* sm = reinterpret_cast<char*>(smem_v);
  // C and B are zero-padded to 64 columns whatever N: the score loop then
  // has a fixed depth (four k16 steps), which measured faster than a
  // depth set by N
  const int Qp = (Q + 15) / 16 * 16;
  constexpr int NP = kT;
  const int PS = 8 * PT, p0 = blockIdx.y * PS;   // this block's columns
  const MmaLayout lay(Qp, NP, PS);
  __nv_bfloat16* Cm = reinterpret_cast<__nv_bfloat16*>(sm + lay.c);
  __nv_bfloat16* Bm = reinterpret_cast<__nv_bfloat16*>(sm + lay.b);
  __nv_bfloat16* Xm = reinterpret_cast<__nv_bfloat16*>(sm + lay.x);
  uint32_t* Hm = reinterpret_cast<uint32_t*>(sm + lay.hi);
  uint32_t* Lm = reinterpret_cast<uint32_t*>(sm + lay.lo);
  float* dts_ = reinterpret_cast<float*>(sm + lay.dt);
  float* css = reinterpret_cast<float*>(sm + lay.cs);
  float* dec = reinterpret_cast<float*>(sm + lay.dec);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.bar);
  double* wsum = reinterpret_cast<double*>(sm + lay.wsum);
  const int ldk = lay.ldk, ldx = lay.ldx, ldh = lay.ldh;

  const int h = blockIdx.x;
  const int bi = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nstages = (Qp + kStage - 1) / kStage;

  const __nv_bfloat16* xb = x + bi * xs.b + ci * xs.c + h * xs.h + p0;
  const __nv_bfloat16* Bb = B + bi * Bs.b + ci * Bs.c + h * Bs.h;
  const __nv_bfloat16* Cb = C + bi * Cs.b + ci * Cs.c + h * Cs.h;
  const float* dtb = dt + bi * dts.b + ci * dts.c + h * dts.h;
  const float* dAb = dA + bi * dAs.b + ci * dAs.c + h * dAs.h;

  // the scan's inputs first: their latency overlaps the copies below
  const float dav = t < Q ? dAb[t * dAs.q] : 0.f;
  const float dtv = t < Q ? dtb[t * dts.q] : 0.f;
  if (t == 0)
    for (int s = 0; s < nstages; ++s) repro::mbar_init(&bars[s], kMmaThreads);
  __syncthreads();

  // ---- C, B and this block's columns of x by cp.async, one mbarrier per
  // 64-row stage
  for (int s = 0; s < nstages; ++s) {
    const int r0 = s * kStage, r1 = min(Q, r0 + kStage);
    issue_rows(Cm, ldk, Cb, Cs.q, N / 8, r0, r1, t);
    issue_rows(Bm, ldk, Bb, Bs.q, N / 8, r0, r1, t);
    issue_rows(Xm, ldx, xb, xs.q, PS / 8, r0, r1, t);
    cp_async_arrive(&bars[s]);
  }
  // zeros where the tiles are padded: C/B columns N..NP, rows Q..Qp
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = t; e < Q * (NP - N); e += kMmaThreads) {
    const int q = e / (NP - N), c = N + e % (NP - N);
    Cm[q * ldk + c] = zero;
    Bm[q * ldk + c] = zero;
  }
  for (int e = t; e < (Qp - Q) * ldk; e += kMmaThreads) {
    Cm[Q * ldk + e] = zero;
    Bm[Q * ldk + e] = zero;
  }
  for (int e = t; e < (Qp - Q) * ldx; e += kMmaThreads) Xm[Q * ldx + e] = zero;

  // ---- cs = cumsum(dA): warp-shuffle scans in f64, then the warps'
  // totals in order; rounded once to f32.  The running sum at Q - 1 is
  // kept beside the totals, so every thread forms cs_last (bit for bit the
  // value of cs[Q - 1]) without a second barrier.
  double v = dav;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  if (t == Q - 1) wsum[kMmaWarps] = v;
  if (t < Qp) dts_[t] = dtv;
  __syncthreads();
  double pre = 0.0, pre_last = 0.0;
  for (int w = 0; w < kMmaWarps; ++w) {
    if (w < warp) pre += wsum[w];
    if (w < (Q - 1) / 32) pre_last += wsum[w];
  }
  if (t < Qp) {
    const float last = (float)(wsum[kMmaWarps] + pre_last);
    const float c = t < Q ? (float)(v + pre) : last;   // padded rows: no
    css[t] = c;                                         // decay, B = 0
    dec[t] = expf(last - c);
  }

  // ---- dt·x split into TF32 halves, once per element, stage by stage as
  // the copies land (a stage's split overlaps the later stages' copies)
  for (int s = 0; s < nstages; ++s) {
    repro::mbar_wait(&bars[s], 0);
    const int r0 = s * kStage, rows = min(Qp, r0 + kStage) - r0;
    for (int e = t; e < rows * PS; e += kMmaThreads) {
      const int q = r0 + e / PS, c = e % PS;
      uint32_t hv, lv;
      split_tf32(bf16_at(Xm + q * ldx + c) * dts_[q], hv, lv);
      Hm[dtx_row(q) * ldh + c] = hv;
      Lm[dtx_row(q) * ldh + c] = lv;
    }
  }
  __syncthreads();

  // The 16-row units, y's row stripes and S's state-row stripes, in order
  // of falling cost, dealt to the warps in a snake (0..7, 7..0, ...): a
  // static form of longest-first, computed by every thread with no shared
  // state.  A y step (scores, exp and the products) is weighted twice an S
  // step (the products alone), and a y unit two steps more for its set-up
  // and stores.  ssd_chunk.py::mma_units deals the same way (its test
  // checks that every stripe goes to exactly one warp).
  const int ny = Qp / 16, ns = (N + 15) / 16;
  constexpr int nk = NP / 16;
  const int cost_s = (Qp / 8) * (2 + 3 * PT);
  int heavy = 0;                     // y stripes that cost more than S's
  for (int r = 0; r < ny; ++r)
    heavy += (2 * r + 4) * 2 * (nk + 3 * PT) > cost_s;
  for (int round = 0;; ++round) {
    const int k = round * kMmaWarps +
                  ((round & 1) ? kMmaWarps - 1 - warp : warp);
    if (k >= ny + ns) break;
    const int unit = k < heavy ? ny - 1 - k
                     : k < heavy + ns ? ny + (k - heavy)
                                      : ny - 1 - (k - ns);
    // the hi·hi products in acc, the two correction terms in cor: two
    // short chains per tile instead of one of three
    float acc[PT][4], cor[PT][4];
#pragma unroll
    for (int a = 0; a < PT; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = cor[a][c] = 0.f;

    if (unit < ny) {
      // ---- y rows [i0, i0 + 16), keys in chunks of 32: the chunk's four
      // score tiles are independent chains, issued interleaved
      const int i0 = unit * 16, ia = i0 + g, ib = ia + 8;
      uint32_t ca[nk][4];
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        const __nv_bfloat16* c0 = Cm + ia * ldk + kk * 16 + 2 * tq;
        ca[kk][0] = u32_at(c0);
        ca[kk][1] = u32_at(c0 + 8 * ldk);
        ca[kk][2] = u32_at(c0 + 8);
        ca[kk][3] = u32_at(c0 + 8 * ldk + 8);
      }
      const float csa = css[ia], csb = css[ib];
      for (int jc = 0; jc < i0 + 16; jc += 32) {
        const int steps = min(4, (i0 + 16 - jc) / 8);
        float sc[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[ks][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < nk; ++kk)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (ks < steps) {
              const __nv_bfloat16* b0 =
                  Bm + (jc + 8 * ks + g) * ldk + kk * 16 + 2 * tq;
              mma_bf16(sc[ks], ca[kk], u32_at(b0), u32_at(b0 + 8));
            }
        // sc[ks]: rows ia (0, 1) and ib (2, 3), keys j, j + 1; the mask
        // before exp; the A fragment of m16n8k8 with k-slot tq <-> key j,
        // tq + 4 <-> key j + 1
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < steps) {
            const int j = jc + 8 * ks + 2 * tq;
            const float cj = css[j], cj1 = css[j + 1];
            split_tf32(sc[ks][0] * expf(j <= ia ? csa - cj : -CUDART_INF_F),
                       ahi[ks][0], alo[ks][0]);
            split_tf32(sc[ks][2] * expf(j <= ib ? csb - cj : -CUDART_INF_F),
                       ahi[ks][1], alo[ks][1]);
            split_tf32(
                sc[ks][1] * expf(j + 1 <= ia ? csa - cj1 : -CUDART_INF_F),
                ahi[ks][2], alo[ks][2]);
            split_tf32(
                sc[ks][3] * expf(j + 1 <= ib ? csb - cj1 : -CUDART_INF_F),
                ahi[ks][3], alo[ks][3]);
          }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < steps) {
            const int r0 = (jc + 8 * ks + tq) * ldh + g, r1 = r0 + 4 * ldh;
#pragma unroll
            for (int nt = 0; nt < PT; ++nt) {
              const uint32_t h0 = Hm[r0 + 8 * nt], h1 = Hm[r1 + 8 * nt];
              mma_tf32(cor[nt], ahi[ks], Lm[r0 + 8 * nt], Lm[r1 + 8 * nt]);
              mma_tf32(cor[nt], alo[ks], h0, h1);
              mma_tf32(acc[nt], ahi[ks], h0, h1);
            }
          }
      }
      float* yb = y + (((long long)bi * nc + ci) * Q * H + h) * P + p0;
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) {
        const int p = nt * 8 + 2 * tq;
        if (ia < Q)
          *reinterpret_cast<float2*>(yb + (long long)ia * H * P + p) =
              make_float2(acc[nt][0] + cor[nt][0], acc[nt][1] + cor[nt][1]);
        if (ib < Q)
          *reinterpret_cast<float2*>(yb + (long long)ib * H * P + p) =
              make_float2(acc[nt][2] + cor[nt][2], acc[nt][3] + cor[nt][3]);
      }
    } else {
      // ---- S rows [n0, n0 + 16): (B ⊙ decay)ᵀ (dt·x) over every key,
      // k-slot tq <-> key q0 + 2tq and tq + 4 <-> q0 + 2tq + 1, as for y;
      // two k-steps at a time
      const int n0 = (unit - ny) * 16, na = n0 + g, nb = na + 8;
      for (int q16 = 0; q16 < Qp; q16 += 16) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int q = q16 + 8 * ks + 2 * tq;
          const float d = dec[q], d1 = dec[q + 1];
          split_tf32(bf16_at(Bm + q * ldk + na) * d, ahi[ks][0], alo[ks][0]);
          split_tf32(bf16_at(Bm + q * ldk + nb) * d, ahi[ks][1], alo[ks][1]);
          split_tf32(bf16_at(Bm + (q + 1) * ldk + na) * d1, ahi[ks][2],
                     alo[ks][2]);
          split_tf32(bf16_at(Bm + (q + 1) * ldk + nb) * d1, ahi[ks][3],
                     alo[ks][3]);
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int r0 = (q16 + 8 * ks + tq) * ldh + g, r1 = r0 + 4 * ldh;
#pragma unroll
          for (int nt = 0; nt < PT; ++nt) {
            const uint32_t h0 = Hm[r0 + 8 * nt], h1 = Hm[r1 + 8 * nt];
            mma_tf32(cor[nt], ahi[ks], Lm[r0 + 8 * nt], Lm[r1 + 8 * nt]);
            mma_tf32(cor[nt], alo[ks], h0, h1);
            mma_tf32(acc[nt], ahi[ks], h0, h1);
          }
        }
      }
      float* Sb = S + (((long long)bi * nc + ci) * H + h) * N * P + p0;
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) {
        const int p = nt * 8 + 2 * tq;
        if (na < N)
          *reinterpret_cast<float2*>(Sb + na * P + p) =
              make_float2(acc[nt][0] + cor[nt][0], acc[nt][1] + cor[nt][1]);
        if (nb < N)
          *reinterpret_cast<float2*>(Sb + nb * P + p) =
              make_float2(acc[nt][2] + cor[nt][2], acc[nt][3] + cor[nt][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum KernelId { kFwd = 0, kDecode = 1, kMma = 2 };

// the dynamic shared memory attribute, once per kernel (a thread-safe
// static), not on every launch: decode launches K5 once per layer per token
template <typename F>
cudaError_t smem_attr(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// a block's most dynamic shared memory on the current device
int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

template <typename T>
int launch_fwd(const void* x, const void* dt, const void* B, const void* C,
               const void* dA, void* y, void* S, int b, int nc, int Q, int H,
               int P, int N, Strides xs, Strides dts, Strides Bs, Strides Cs,
               Strides dAs, cudaStream_t stream) {
  static const cudaError_t attr = smem_attr(ssd_chunk_fwd<T>, (int)kSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Q + kT - 1) / kT + 1, H, b * nc);
  ssd_chunk_fwd<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(dA), static_cast<float*>(y),
      static_cast<float*>(S), nc, Q, H, P, N, xs, dts, Bs, Cs, dAs);
  return cudaGetLastError();
}

template <typename T>
int launch_decode(const void* x, const void* dt, const void* B, const void* C,
                  const void* dA, void* y, void* S, int b, int nc, int Q,
                  int H, int P, int N, int splits, Strides xs, Strides dts,
                  Strides Bs, Strides Cs, Strides dAs, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  if (Q > kDecMaxQ || splits < 1 || splits > N || P % V || N % V ||
      P / V > 32)
    return cudaErrorInvalidValue;
  dim3 grid(H, splits, b * nc);
  ssd_decode<T><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(dA), static_cast<float*>(y),
      static_cast<float*>(S), nc, Q, H, P, N, splits, xs, dts, Bs, Cs, dAs);
  return cudaGetLastError();
}

template <int PT>
int launch_mma_pt(const void* x, const void* dt, const void* B,
                  const void* C, const void* dA, void* y, void* S, int b,
                  int nc, int Q, int H, int P, int N, int pslices,
                  Strides xs, Strides dts, Strides Bs, Strides Cs,
                  Strides dAs, cudaStream_t stream) {
  // the plan's slices fit the card's limit; a launch past it fails
  const int bytes = MmaLayout((Q + 15) / 16 * 16, kT, 8 * PT).total;
  static const cudaError_t attr = smem_attr(ssd_chunk_mma<PT>, smem_optin());
  if (attr != cudaSuccess) return attr;
  dim3 grid(H, pslices, b * nc);
  ssd_chunk_mma<PT><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(dA),
      static_cast<float*>(y), static_cast<float*>(S), nc, Q, H, P, N, xs, dts,
      Bs, Cs, dAs);
  return cudaGetLastError();
}

int launch_mma(const void* x, const void* dt, const void* B, const void* C,
               const void* dA, void* y, void* S, int b, int nc, int Q, int H,
               int P, int N, int pslices, Strides xs, Strides dts, Strides Bs,
               Strides Cs, Strides dAs, cudaStream_t stream) {
  if (N % 8 || pslices < 1 || P % (8 * pslices)) return cudaErrorInvalidValue;
  switch (P / pslices / 8) {
    case 1:
      return launch_mma_pt<1>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N,
                              pslices, xs, dts, Bs, Cs, dAs, stream);
    case 2:
      return launch_mma_pt<2>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N,
                              pslices, xs, dts, Bs, Cs, dAs, stream);
    case 4:
      return launch_mma_pt<4>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N,
                              pslices, xs, dts, Bs, Cs, dAs, stream);
    case 8:
      return launch_mma_pt<8>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N,
                              pslices, xs, dts, Bs, Cs, dAs, stream);
  }
  return cudaErrorInvalidValue;   // a slice of P that is not 8, 16, 32, 64
}

}  // namespace

// x (b,nc,Q,H,P), B/C (b,nc,Q,H,N) in `dtype`, unit stride on the last
// axis; dt/dA (b,nc,Q,H) f32.  Element strides of the (b, c, q, h) axes
// for each input (a stride-0 head axis broadcasts B/C from one group).
// y (b,nc,Q,H,P) and S (b,nc,H,N,P) contiguous f32.  `kernel` is the
// plan's choice (KernelId); `splits` is ssd_decode's slices of S's rows and
// ssd_chunk_mma's slices of P.  ssd_decode and ssd_chunk_mma read 16-byte
// vectors: the caller passes rows that start on 16 bytes.
extern "C" int repro_ssd_chunk(
    const void* x, const void* dt, const void* B, const void* C,
    const void* dA, void* y, void* S, int dtype, int kernel, int splits,
    int b, int nc, int Q, int H, int P, int N,
    long long xsb, long long xsc, long long xsq, long long xsh,
    long long dtsb, long long dtsc, long long dtsq, long long dtsh,
    long long Bsb, long long Bsc, long long Bsq, long long Bsh,
    long long Csb, long long Csc, long long Csq, long long Csh,
    long long dAsb, long long dAsc, long long dAsq, long long dAsh,
    void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kT || N < 1 || N > kT)
    return cudaErrorInvalidValue;
  const Strides xs{xsb, xsc, xsq, xsh}, dts{dtsb, dtsc, dtsq, dtsh},
      Bs{Bsb, Bsc, Bsq, Bsh}, Cs{Csb, Csc, Csq, Csh},
      dAs{dAsb, dAsc, dAsq, dAsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (kernel == kMma) {
    if (dtype != repro::kBF16) return cudaErrorInvalidValue;
    return launch_mma(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N, splits, xs,
                      dts, Bs, Cs, dAs, st);
  }
  if (kernel == kDecode) {
    if (dtype == repro::kF32)
      return launch_decode<float>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N,
                                  splits, xs, dts, Bs, Cs, dAs, st);
    if (dtype == repro::kBF16)
      return launch_decode<__nv_bfloat16>(x, dt, B, C, dA, y, S, b, nc, Q, H,
                                          P, N, splits, xs, dts, Bs, Cs, dAs,
                                          st);
    return cudaErrorInvalidValue;
  }
  if (kernel != kFwd) return cudaErrorInvalidValue;
  if (dtype == repro::kF32)
    return launch_fwd<float>(x, dt, B, C, dA, y, S, b, nc, Q, H, P, N, xs,
                             dts, Bs, Cs, dAs, st);
  if (dtype == repro::kBF16)
    return launch_fwd<__nv_bfloat16>(x, dt, B, C, dA, y, S, b, nc, Q, H, P,
                                     N, xs, dts, Bs, Cs, dAs, st);
  return cudaErrorInvalidValue;
}
