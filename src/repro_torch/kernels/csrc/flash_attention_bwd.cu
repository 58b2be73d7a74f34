// K2's backward — the gradients of GQA flash attention, two routes chosen
// by input type.
//
// The JAX package has no backward Pallas kernel: it differentiates the jnp
// attention repro/models/layers.py::mha (layers.py:116) with XLA's
// autodiff.  This is the port's hand-written counterpart of that
// gradient, for the forward of flash_attention.cu (flash_fwd_wgmma in
// bf16, flash_fwd in f32) without window or MLA mode: GQA (h % n == 0),
// causal or not, query i at position q_offset + i, keys >= kv_len masked,
// e in {16, 64, 128}, f32 accumulators.
//
// With P = exp(S·scale - lse) recomputed from the forward's LSE (natural
// log, f32 (b, h, sq)), scale = 1/sqrt(e):
//   D  = rowsum(dO ⊙ O)
//   dV = Pᵀ·dO,  dK = dSᵀ·Q·scale, summed over the g query heads of each kv
//   head, with dP = dO·Vᵀ and dS = P ⊙ (dP - D)
//   dQ = dS·K·scale
// Two passes with no float atomics, a dK/dV pass whose blocks own keys and
// a dQ pass whose blocks own query rows, so S and dP are computed in both;
// where a pass's blocks would be too few for the card, its range is split
// and flash_bwd_sum adds the splits' f32 partials in split order.  So
// every gradient is the same bits from run to run.
//
// What bounds it on the H100: at the training shape (b 8, 256 positions,
// 16 heads of 64, causal) the inputs and outputs are 8 tensors of 4.2 MB
// (about 10 µs at 3.35 TB/s) and the 5 products about 2.7 GFLOP (2.7 µs
// on the bf16 tensor cores), so bytes bound it; in practice how long a
// block's chain of tiles takes, and how many SMs the grid keeps busy.
//
// bf16: flash_bwd_prep, flash_bwd_dkdv_wgmma, flash_bwd_dq_wgmma (+
// flash_bwd_sum), every product on the tensor cores by wgmma, in the
// layout conventions of hopper.cuh and flash_fwd_wgmma's:
//  * Rows of a query tile are (query position, head of the group), as the
//    forward's Q box lands them: the g = h/n heads of a kv head share each
//    64-row tile, so one K/V tile serves all g heads and the dK/dV pass
//    sums over them inside its accumulators (no per-head shares).
//  * flash_bwd_prep writes, per row of that packed order, the LSE in base
//    2, D, and the row's key limit (the keys it sees are those below it:
//    the causal edge, kv_len, 0 for a padding row), so both passes mask a
//    key with one compare and read a tile's row data with one bulk copy.
//  * flash_bwd_dkdv_wgmma: a block (one warpgroup) owns 64 keys of a kv
//    head, its K and V tiles resident, and walks the query tiles that can
//    see them (causal: from the first that sees its first key; split into
//    f32 partials where blocks are few, flash_attention_bwd.py::
//    wgmma_plan).  Per tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (both operands in
//    shared memory, K-major), Pᵀ and dSᵀ on the accumulator fragments
//    (masked before exp2; the exponentials run while dPᵀ is still on the
//    tensor cores), then dV += Pᵀ·dO and dK += dSᵀ·Q with A from registers
//    (the fragments packed to bf16 in place, as the forward does with P)
//    and B MN-major (the transpose bit).  Q, dO and the row data arrive by
//    TMA and the bulk-copy unit into a ring of 2 (e = 128) or 3 stages.
//  * flash_bwd_dq_wgmma: a block owns a 64-row query tile, Q and dO
//    resident, and walks its key split's tiles, K/V by TMA into a ring of
//    2 stages (3 at e = 16): S = Q·Kᵀ, dP = dO·Vᵀ, P and dS in registers,
//    dQ += dS·K.  The key range is split where query tiles are few (16
//    queries over 1601 keys).
//  * Registers: one warpgroup per block and no producer warp.  At e = 128
//    the dK and dV accumulators of 64 keys take 2 x 64 f32 a thread and
//    Sᵀ/dPᵀ 2 x 32 more; Pᵀ and dSᵀ are both formed before either is packed
//    and the accumulating products issued, so no more than those 192 are
//    live at once (ptxas' report shows the count and any spill).  Two
//    warpgroups on 128 keys would keep the same count a thread, and
//    splitting e into two passes would compute Sᵀ and dPᵀ twice.
//  * P and dS enter their products as bf16 hi + lo pairs (pack_hilo: the
//    value rounded, and the remainder rounded; two wgmmas into one
//    accumulator), about 16 bits, where the plain version keeps them in
//    f32.  Rounded once, as SDPA's are, dS took dK past the limit the
//    backward is held to in bf16 (2e-3·max|want| + 1e-2·|want|) at
//    chip_smoke.py's g 2, e 128 shape on the H100: dS = P ⊙ (dP - D)
//    holds terms of |dP| ~ sqrt(e) whose sums over a key's queries cancel.
//    As pairs, each term is off by about 2^-16 of itself, under the
//    gradients' own rounding.  The pairs cost two more 64-row products a
//    query tile in the dK/dV pass, one in dQ's.
// f32: flash_bwd_delta, flash_bwd_dkdv, flash_bwd_dq (+ flash_bwd_sum) on
// the CUDA cores (wgmma has no full-f32 mode, and TF32 would break the
// 2e-5 f32 is held to): tiles staged in shared memory as f32, a 16 x 16
// thread grid, each thread a 4 x 4 patch of a 64 x 64 product; a dK/dV
// block owns 64 keys of one query head and writes its head's share in f32
// where g > 1, flash_bwd_sum adding the g shares in head order.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kB = 64;          // query rows and keys of a tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx) holds rows
                                // ty + 16a and columns tx + 16c of a tile
constexpr int kLdP = kB + 1;    // row stride of a 64 x 64 tile (floats)
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: four 64 x E tiles (Q, dO, K, V) at row stride E + 1 (the
// +1 keeps the 16 rows a warp reads in a column on 16 banks), two 64 x 64
// tiles (P, dS), and the 64 rows' LSE and D
template <int E>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kB * (E + 1) + 2 * kB * kLdP + 2 * kB);
}

// rows [r0, r0 + 64) of one head of a contiguous (.., rows, heads, E)
// tensor (src at row 0 of that head; rows row_stride apart) into dst
// [64][E + 1] as f32, rows at or past nrows as 0
template <int E>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int nrows) {
  for (int i = threadIdx.x; i < kB * E; i += kThreads) {
    const int r = i / E, c = i % E;
    dst[r * (E + 1) + c] =
        r0 + r < nrows ? src[(long long)(r0 + r) * row_stride + c] : 0.f;
  }
}

// D = rowsum(dO ⊙ O) in f32, one warp a row of (b, sq, h) -> delta
// (b, h, sq)
__global__ void __launch_bounds__(256)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ delta, long long rows, int sq, int h,
                int e) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp: one row per warp
  float s = 0.f;
  for (int j = lane; j < e; j += 32)
    s += o[row * e + j] * dout[row * e + j];
  s = repro::warp_sum(s);
  if (lane == 0) {
    const long long hh = row % h, pos = (row / h) % sq,
                    bi = row / ((long long)h * sq);
    delta[(bi * h + hh) * sq + pos] = s;
  }
}

// S = A·Bᵀ and dP = C·Dᵀ over 64 x E tiles (rows of A/C: queries, of B/D:
// keys) for this thread's 4 x 4 patch; only the first xs of the four
// 16-row groups of queries (a tile past the last query holds fewer: 16
// queries over 1601 keys fill one), a bound the whole block shares
template <int E>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* d,
                                             float (&s)[4][4],
                                             float (&dp)[4][4], int ty,
                                             int tx, int xs) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) s[x][y] = dp[x][y] = 0.f;
#pragma unroll 4
  for (int j = 0; j < E; ++j) {
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      av[x] = a[(ty + 16 * x) * (E + 1) + j];
      cv[x] = c[(ty + 16 * x) * (E + 1) + j];
      bv[x] = b[(tx + 16 * x) * (E + 1) + j];
      dv[x] = d[(tx + 16 * x) * (E + 1) + j];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (x >= xs) break;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        s[x][y] += av[x] * bv[y];
        dp[x][y] += cv[x] * dv[y];
      }
    }
  }
}

// Block (key tile, query head, b): keys [k0, k0 + 64) of query head hh's
// kv head; walks the query tiles of head hh that can see one of its keys,
// accumulating dK and dV in registers, and writes them once (0 for keys
// no query sees): in T into dk/dv (b, sk, n, e) where g = 1, else in f32
// into head hh's share part_dk/part_dv (b, sk, h, e).
template <int E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ part_dk,
               float* __restrict__ part_dv, int sq, int h, int n, int sk,
               int kv_len, int q_offset, int causal, float scale) {
  constexpr int LD = E + 1, NC = E / 16;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kB * LD;
  float* qs = vs + kB * LD;
  float* dos = qs + kB * LD;
  float* ps = dos + kB * LD;     // [query][key]
  float* dss = ps + kB * kLdP;   // [query][key]
  float* lse_s = dss + kB * kLdP;
  float* d_s = lse_s + kB;
  const int k0 = blockIdx.x * kB, hh = blockIdx.y, bi = blockIdx.z;
  const int g = h / n, kvh = hh / g, t = threadIdx.x, tx = t & 15,
            ty = t >> 4;
  const long long qrow = (long long)h * E, krow = (long long)n * E;
  const float scale_log2 = scale * kLog2e;

  float acc_dk[4][NC], acc_dv[4][NC];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_dk[x][c] = acc_dv[x][c] = 0.f;

  // the first query that sees key k0 (causal: q_offset + i >= k0)
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  if (k0 < kv_len && i_lo < sq) {
    const float* kb = k + (long long)bi * sk * krow + kvh * E;
    const float* vb = v + (long long)bi * sk * krow + kvh * E;
    load_tile<E>(ks, kb, krow, k0, kv_len);
    load_tile<E>(vs, vb, krow, k0, kv_len);
    {
      const float* qb = q + (long long)bi * sq * qrow + hh * E;
      const float* ob = dout + (long long)bi * sq * qrow + hh * E;
      const long long lrow = ((long long)bi * h + hh) * sq;
      for (int q0 = i_lo / kB * kB; q0 < sq; q0 += kB) {
        __syncthreads();  // the previous tile's reads are done
        load_tile<E>(qs, qb, qrow, q0, sq);
        load_tile<E>(dos, ob, qrow, q0, sq);
        if (t < kB) {
          const bool in = q0 + t < sq;
          lse_s[t] = in ? lse[lrow + q0 + t] * kLog2e : 0.f;
          d_s[t] = in ? delta[lrow + q0 + t] : 0.f;
        }
        __syncthreads();
        const int rows = min(kB, sq - q0), xs = (rows + 15) / 16;
        float s[4][4], dp[4][4];
        two_products<E>(qs, ks, dos, vs, s, dp, ty, tx, xs);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (x >= xs) break;  // rows no later loop reads
          const int r = ty + 16 * x, i = q0 + r;
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int key = k0 + tx + 16 * y;
            const bool vis = i < sq && key < kv_len &&
                             (!causal || q_offset + i >= key);
            const float p = vis ? exp2f(s[x][y] * scale_log2 - lse_s[r]) : 0.f;
            ps[r * kLdP + tx + 16 * y] = p;
            dss[r * kLdP + tx + 16 * y] = p * (dp[x][y] - d_s[r]);
          }
        }
        __syncthreads();
        // dV += Pᵀ dO and dK += dSᵀ Q over the tile's query rows: rows are
        // keys, columns features
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          float pa[4], sa[4], ob_[NC], qv[NC];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[x] = ps[r * kLdP + ty + 16 * x];
            sa[x] = dss[r * kLdP + ty + 16 * x];
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            ob_[c] = dos[r * LD + tx + 16 * c];
            qv[c] = qs[r * LD + tx + 16 * c];
          }
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc_dv[x][c] += pa[x] * ob_[c];
              acc_dk[x][c] += sa[x] * qv[c];
            }
        }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int key = k0 + ty + 16 * x;
    if (key >= sk) continue;
    if (g == 1) {
      const long long at = ((long long)bi * sk + key) * krow + kvh * E;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dk[at + tx + 16 * c] = acc_dk[x][c] * scale;
        dv[at + tx + 16 * c] = acc_dv[x][c];
      }
    } else {
      const long long at = ((long long)bi * sk + key) * qrow + hh * E;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        part_dk[at + tx + 16 * c] = acc_dk[x][c] * scale;
        part_dv[at + tx + 16 * c] = acc_dv[x][c];
      }
    }
  }
}

// Block (query tile x split, head, b): query rows [q0, q0 + 64) of head
// hh; walks the key tiles of its split ([split·chunk, +chunk)) that they
// can see, accumulating dQ in registers; writes it in T into dq (b, sq, h,
// e) when there is one split, else in f32 into the split's partial
// part_dq (nsplit, b, sq, h, e).
template <int E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, float* __restrict__ part_dq, int b,
             int sq, int h, int n, int sk, int kv_len, int q_offset, int causal,
             float scale, int chunk, int nsplit) {
  constexpr int LD = E + 1, NC = E / 16;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kB * LD;
  float* qs = vs + kB * LD;
  float* dos = qs + kB * LD;
  float* dss = dos + kB * LD + kB * kLdP;   // the layout of flash_bwd_dkdv
  float* lse_s = dss + kB * kLdP;
  float* d_s = lse_s + kB;
  const int split = blockIdx.x % nsplit, q0 = blockIdx.x / nsplit * kB;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const int kvh = hh / (h / n), t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const long long qrow = (long long)h * E, krow = (long long)n * E;
  const float scale_log2 = scale * kLog2e;
  const long long lrow = ((long long)bi * h + hh) * sq;
  const int xs = (min(kB, sq - q0) + 15) / 16;  // 16-row groups with queries

  load_tile<E>(qs, q + (long long)bi * sq * qrow + hh * E, qrow, q0, sq);
  load_tile<E>(dos, dout + (long long)bi * sq * qrow + hh * E, qrow, q0,
                  sq);
  if (t < kB) {
    const bool in = q0 + t < sq;
    lse_s[t] = in ? lse[lrow + q0 + t] * kLog2e : 0.f;
    d_s[t] = in ? delta[lrow + q0 + t] : 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[x][c] = 0.f;
  // one past the last key a row of this tile sees, within this split
  int kend = min(kv_len, (split + 1) * chunk);
  if (causal) kend = min(kend, q_offset + min(q0 + kB, sq));
  const float* kb = k + (long long)bi * sk * krow + kvh * E;
  const float* vb = v + (long long)bi * sk * krow + kvh * E;
  for (int k0 = split * chunk; k0 < kend; k0 += kB) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<E>(ks, kb, krow, k0, kv_len);
    load_tile<E>(vs, vb, krow, k0, kv_len);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<E>(qs, ks, dos, vs, s, dp, ty, tx, xs);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (x >= xs) break;
      const int r = ty + 16 * x, i = q0 + r;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int key = k0 + tx + 16 * y;
        const bool vis =
            i < sq && key < kv_len && (!causal || q_offset + i >= key);
        const float p = vis ? exp2f(s[x][y] * scale_log2 - lse_s[r]) : 0.f;
        dss[r * kLdP + tx + 16 * y] = p * (dp[x][y] - d_s[r]);
      }
    }
    __syncthreads();
    // dQ += dS K over the tile's keys: rows are queries, columns features
    const int keys = min(kB, kend - k0);
#pragma unroll 4
    for (int j = 0; j < keys; ++j) {
      float sa[4], kv[NC];
#pragma unroll
      for (int x = 0; x < 4; ++x) sa[x] = dss[(ty + 16 * x) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (x >= xs) break;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[x][c] += sa[x] * kv[c];
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = q0 + ty + 16 * x;
    if (i >= sq) continue;
    const long long at = ((long long)bi * sq + i) * qrow + hh * E;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (nsplit == 1)
        dq[at + tx + 16 * c] = acc[x][c] * scale;
      else
        part_dq[split * (long long)b * sq * qrow + at + tx + 16 * c] =
            acc[x][c] * scale;
    }
  }
}

// out (rows x e, in T) = the sum over j < parts, in order, of f32
// partials: out row r = (o, grp), grp = r % groups, element c reads
// part[(o · stride_o + grp · per_grp) · e + c + j · jstride].  dK/dV: the
// g query-head shares of kv head grp, adjacent rows of (b, sk, h, e)
// (groups n, stride_o h, per_grp g, jstride e); dQ: the nsplit key splits
// (groups 1, stride_o 1, jstride a whole partial).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum(const float* __restrict__ part, T* __restrict__ out,
              long long rows, int groups, int stride_o, int per_grp,
              int parts, long long jstride, int e) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * e) return;
  const long long r = i / e, o = r / groups;
  const int grp = (int)(r % groups), c = (int)(i % e);
  const long long base = (o * stride_o + (long long)grp * per_grp) * e + c;
  float acc = 0.f;
  for (int j = 0; j < parts; ++j) acc += part[base + j * jstride];
  out[i] = repro::from_f<T>(acc);
}

template <typename T>
cudaError_t sum_parts(const float* part, void* out, long long rows,
                      int groups, int stride_o, int per_grp, int parts,
                      long long jstride, int e, cudaStream_t stream) {
  const long long n = rows * e;
  flash_bwd_sum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, static_cast<T*>(out), rows, groups, stride_o, per_grp, parts,
      jstride, e);
  return cudaGetLastError();
}

template <int E>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, float* part_kv, float* part_q, int b, int sq, int h,
           int n, int sk, int kv_len, int q_offset, int causal, int chunk,
           int nsplit, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<E>();
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const long long rows = (long long)b * sq * h;
  flash_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(o), dot, delta, rows, sq, h, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)E);
  const int g = h / n;
  const long long kv_part = (long long)b * sk * h * E;  // one share array
  flash_bwd_dkdv<E><<<dim3((sk + kB - 1) / kB, h, b), kThreads, smem,
                      stream>>>(qt, kt, vt, dot, lse, delta,
                                static_cast<float*>(dk),
                                static_cast<float*>(dv), part_kv,
                                g > 1 ? part_kv + kv_part : nullptr, sq, h,
                                n, sk, kv_len, q_offset, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (g > 1) {  // dk, dv row (b·sk + key, kvh) = sum of shares kvh·g + j
    const long long kv_rows = (long long)b * sk * n;
    err = sum_parts<float>(part_kv, dk, kv_rows, n, h, g, g, E, E, stream);
    if (err != cudaSuccess) return err;
    err = sum_parts<float>(part_kv + kv_part, dv, kv_rows, n, h, g, g, E,
                           E, stream);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq<E><<<dim3((sq + kB - 1) / kB * nsplit, h, b), kThreads,
                    smem, stream>>>(qt, kt, vt, dot, lse, delta,
                                    static_cast<float*>(dq), part_q, b, sq,
                                    h, n, sk, kv_len, q_offset, causal,
                                    scale, chunk, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  // dq row r (of the b·sq·h rows) = the sum over splits s of part_q[s]'s
  return sum_parts<float>(part_q, dq, rows, 1, 1, 0, nsplit, rows * E, E,
                      stream);
}

// ---------------------------------------------------------------------------
// bf16: wgmma, tiles by TMA
// ---------------------------------------------------------------------------

constexpr int kWG = 128;  // one warpgroup

// One row of a query tile in the packed order, written by flash_bwd_prep:
// the forward's LSE times log2(e), D, and the row's key limit (it sees the
// keys below `lim`; 0 for a row past the last query or the tile's rows).
struct __align__(16) RowInfo {
  float lse2;
  float d;
  int lim;
  int pad;
};

// A 64 x E bf16 tile in shared memory, as TMA writes it (hopper.cuh's
// layout convention): kAtoms atoms of 64 rows x kSw bytes
template <int E>
struct Swz {
  static constexpr int kAtom = E < 64 ? E : 64;  // elements per swizzle row
  static constexpr int kSw = 2 * kAtom;          // swizzle bytes: 32 or 128
  static constexpr int kAtoms = E / kAtom;
  static constexpr uint64_t kLayout =
      kSw == 128 ? repro::kSwizzle128 : repro::kSwizzle32;
  static constexpr int kBytes = kB * E * 2;
  static_assert(kSw == 32 || kSw == 128, "e must be 16, 64 or 128");
};

// A pass's shared memory: two resident tiles, then `Stages` pairs of
// streamed ones, the streamed tiles' row data, an mbarrier per stage and
// one for the resident pair
template <int E, int Stages>
struct WTile : Swz<E> {
  static constexpr int kStages = Stages;
  static constexpr int kInfo = kB * (int)sizeof(RowInfo);
  static constexpr int kAlign = 1024;            // the 128-byte swizzle period
  static constexpr size_t kSmem =
      kAlign + (size_t)Swz<E>::kBytes * 2 * (1 + kStages) +
      (size_t)kInfo * kStages + 8 * (kStages + 1);
};

// the dK/dV pass streams 3 stages (2 at e = 128, whose ring holds 2 x 32
// KB); the dQ pass 2 where e >= 64, so that its smaller blocks (122
// registers a thread at e = 64) fit 4 to an SM
template <int E>
using DkdvTile = WTile<E, (E == 128 ? 2 : 3)>;
template <int E>
using DqTile = WTile<E, (E == 16 ? 3 : 2)>;

// descriptor of the k16 step kk of a K-major 64 x E tile (E contiguous)
template <int E>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using TL = Swz<E>;
  const int a = kk * 16 / TL::kAtom, off = (kk * 16 % TL::kAtom) * 2;
  return repro::wgmma_desc(tile + a * kB * TL::kSw + off, 16, 8 * TL::kSw,
                           TL::kLayout);
}

// descriptor of rows [16kk, 16kk + 16) of a 64 x E tile read MN-major: its
// rows are the product's K axis, its E columns the N axis
template <int E>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using TL = Swz<E>;
  return repro::wgmma_desc(tile + kk * 16 * TL::kSw, kB * TL::kSw,
                           8 * TL::kSw, TL::kLayout);
}

// D (64 x 64) = A·Bᵀ over E, both 64 x E tiles K-major
template <int E>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < E / 16; ++kk)
    repro::wgmma_m64n64k16_ss(d, kmajor<E>(a, kk), kmajor<E>(b, kk), kk > 0);
}

// D (64 x E) += A·B, A (64 x 64) the bf16 fragments `a` of four k16 steps,
// B a 64 x E tile read MN-major
template <int E>
__device__ __forceinline__ void product_rs(float (&d)[E / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) repro::wgmma_m64nNk16_rs(d, a[kk],
                                                          mnmajor<E>(b, kk));
}

// a 64 x 64 accumulator as two sets of bf16 A fragments of four k16 steps
// (the accumulator layout is the A-fragment layout): hi, the values
// rounded, and lo, what hi leaves out, rounded; a product taken with both
// and summed keeps about 16 bits of each value
__device__ __forceinline__ void pack_hilo(const float (&x)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = repro::pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// zero rows [rows, 64) of each 64 x E tile at `tiles` (count of them,
// kBytes apart): a query tile's TMA box fills only its rows (g ∤ 64), and
// the rest must read as 0 where it is a product's K axis
template <int E>
__device__ __forceinline__ void zero_tail(uint8_t* tiles, int count,
                                          int rows) {
  using TL = Swz<E>;
  const int per_atom = (kB - rows) * TL::kSw / 16;  // 16-byte chunks
  const int total = count * TL::kAtoms * per_atom;
  for (int i = threadIdx.x; i < total; i += kWG) {
    const int atom = i / per_atom, c = i % per_atom;
    reinterpret_cast<uint4*>(tiles + atom * kB * TL::kSw +
                             rows * TL::kSw)[c] = make_uint4(0, 0, 0, 0);
  }
  repro::fence_proxy_async();
}

// One packed row per E/8 lanes, 16 bytes of O and of dO a lane: row R of
// query tile mt of (b, kv head) is query position mt·per_tile + R/g of
// head kvh·g + R%g.  info (b, n, mtiles, 64).
template <int E>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, RowInfo* __restrict__ info,
               long long rows, int sq, int h, int n, int per_tile,
               int mtiles, int kv_len, int q_offset, int causal) {
  constexpr int kLanes = E / 8;
  const long long row =
      (long long)blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  const int g = h / n, r = (int)(row % kB);
  const long long tile = row / kB;
  const int mt = (int)(tile % mtiles), kvh = (int)(tile / mtiles % n);
  const long long bi = tile / ((long long)mtiles * n);
  const int pos = mt * per_tile + r / g, head = kvh * g + r % g;
  const bool valid = row < rows && r < per_tile * g && pos < sq;
  float s = 0.f;
  if (valid) {
    const long long at = ((bi * sq + pos) * h + head) * E + 8 * part;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]), y = __bfloat1622float2(b2[j]);
      s += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && part == 0) {
    RowInfo ri{0.f, 0.f, 0, 0};
    if (valid) {
      ri.lse2 = lse[(bi * h + head) * sq + pos] * kLog2e;
      ri.d = s;
      ri.lim = causal ? min(kv_len, q_offset + pos + 1) : kv_len;
    }
    info[row] = ri;
  }
}

// Block (64 keys x split, kv head, b): keys [k0, k0 + 64) of kv head
// blockIdx.y, over the query tiles of its split of those that can see one
// of them; writes dK (scaled) and dV in bf16 into dk/dv (b, sk, n, e) when
// there is one split, else in f32 into the split's partials part_kv (2,
// nsplit, b, sk, n, e).
template <int E>
__global__ void __launch_bounds__(kWG, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const RowInfo* __restrict__ info,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ part_kv, int b, int h, int n,
                     int sk, int kv_len, int q_offset, int causal,
                     int per_tile, int mtiles, int nsplit) {
  using TL = DkdvTile<E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((TL::kAlign - (repro::smem_u32(smem_raw) &
                                             (TL::kAlign - 1))) &
                              (TL::kAlign - 1));
  // K, V resident; stage s: Q, dO
  auto q_tile = [&](int s) { return base + TL::kBytes * (2 + 2 * s); };
  auto o_tile = [&](int s) { return base + TL::kBytes * (3 + 2 * s); };
  RowInfo* infos =
      reinterpret_cast<RowInfo*>(base + TL::kBytes * 2 * (1 + TL::kStages));
  uint64_t* bars = reinterpret_cast<uint64_t*>(infos + kB * TL::kStages);
  uint64_t* kvbar = bars + TL::kStages;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int split = blockIdx.x % nsplit, k0 = blockIdx.x / nsplit * kB;
  const int kvh = blockIdx.y, bi = blockIdx.z, g = h / n;
  const int rows = per_tile * g;
  // the query tiles that can see one of the keys (causal: from the one
  // holding position k0 - q_offset), this split's share of them
  const int vis_lo = causal ? max(0, k0 - q_offset) / per_tile : 0;
  const int per = (max(0, mtiles - vis_lo) + nsplit - 1) / nsplit;
  const int m_lo = vis_lo + split * per;
  const int ntiles =
      k0 < kv_len ? max(0, min(mtiles, m_lo + per) - m_lo) : 0;
  const RowInfo* info_b = info + ((long long)bi * n + kvh) * mtiles * kB;

  auto load_q = [&](int j) {  // one thread: tile m_lo + j into its stage
    const int s = j % TL::kStages, mt = m_lo + j;
    repro::mbar_arrive_expect_tx(&bars[s], 2 * rows * E * 2 + TL::kInfo);
#pragma unroll
    for (int a = 0; a < TL::kAtoms; ++a) {
      repro::tma_load_4d(q_tile(s) + a * kB * TL::kSw, &qmap, &bars[s],
                         a * TL::kAtom, kvh * g, mt * per_tile, bi);
      repro::tma_load_4d(o_tile(s) + a * kB * TL::kSw, &omap, &bars[s],
                         a * TL::kAtom, kvh * g, mt * per_tile, bi);
    }
    repro::bulk_load(infos + s * kB, info_b + (long long)mt * kB, TL::kInfo,
                     &bars[s]);
  };
  if (t == 0) {
    for (int s = 0; s <= TL::kStages; ++s) repro::mbar_init(&bars[s], 1);
    repro::mbar_init_fence();
  }
  if (rows < kB) zero_tail<E>(q_tile(0), 2 * TL::kStages, rows);
  __syncthreads();
  if (t == 0 && ntiles > 0) {
    repro::mbar_arrive_expect_tx(kvbar, 2 * TL::kBytes);
#pragma unroll
    for (int a = 0; a < TL::kAtoms; ++a) {
      repro::tma_load_4d(base + a * kB * TL::kSw, &kmap, kvbar,
                         a * TL::kAtom, kvh, k0, bi);
      repro::tma_load_4d(base + TL::kBytes + a * kB * TL::kSw, &vmap, kvbar,
                         a * TL::kAtom, kvh, k0, bi);
    }
    for (int j = 0; j < min(TL::kStages, ntiles); ++j) load_q(j);
  }

  // this thread's keys (the fragment rows: warp w holds 16w + lane/4 and
  // + 8) and, in each Sᵀ/dPᵀ fragment, query rows 8c + 2(lane & 3) + jj
  // in register 4c + 2i + jj
  const int key0 = k0 + warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const float scale_log2 = kLog2e / sqrtf((float)E);
  const uint32_t k_addr = repro::smem_u32(base);
  const uint32_t v_addr = k_addr + TL::kBytes;
  float acc_dk[E / 2], acc_dv[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  if (ntiles > 0) repro::mbar_wait(kvbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % TL::kStages;
    repro::mbar_wait(&bars[s], (j / TL::kStages) & 1);
    const uint32_t q_addr = repro::smem_u32(q_tile(s));
    const uint32_t o_addr = repro::smem_u32(o_tile(s));
    const RowInfo* ri = infos + s * kB;
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    repro::wgmma_fence();
    product_ss<E>(st, k_addr, q_addr);    // Sᵀ = K·Qᵀ
    repro::wgmma_commit();
    product_ss<E>(dpt, v_addr, o_addr);   // dPᵀ = V·dOᵀ
    repro::wgmma_commit();
    repro::wgmma_wait<1>();
    repro::fence_regs(st);
    // Pᵀ, masked before exp2, while dPᵀ is on the tensor cores
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const RowInfo r = ri[8 * c + col0 + jj];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * c + 2 * i + jj;
          st[x] = key0 + 8 * i < r.lim ? exp2f(st[x] * scale_log2 - r.lse2)
                                       : 0.f;
        }
      }
    repro::wgmma_wait<0>();
    repro::fence_regs(dpt);
    // dSᵀ = Pᵀ ⊙ (dPᵀ - D)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float d = ri[8 * c + col0 + jj].d;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * c + 2 * i + jj;
          dpt[x] = st[x] * (dpt[x] - d);
        }
      }
    uint32_t p_hi[4][4], p_lo[4][4], s_hi[4][4], s_lo[4][4];
    pack_hilo(st, p_hi, p_lo);
    pack_hilo(dpt, s_hi, s_lo);
    repro::wgmma_fence();
    product_rs<E>(acc_dv, p_hi, o_addr);  // dV += Pᵀ·dO
    product_rs<E>(acc_dv, p_lo, o_addr);
    product_rs<E>(acc_dk, s_hi, q_addr);  // dK += dSᵀ·Q
    product_rs<E>(acc_dk, s_lo, q_addr);
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(acc_dv);
    repro::fence_regs(acc_dk);
    __syncthreads();  // every read of stage s (wgmma and row data) is done
    if (t == 0 && j + TL::kStages < ntiles) load_q(j + TL::kStages);
  }

  const float scale = 1.f / sqrtf((float)E);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= sk) continue;
    const long long row = ((long long)bi * sk + key) * n + kvh;
    if (nsplit == 1) {
      __nv_bfloat16* kr = dk + row * E + col0;
      __nv_bfloat16* vr = dv + row * E + col0;
#pragma unroll
      for (int c = 0; c < E / 8; ++c) {
        const int x = 4 * c + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(kr + 8 * c) =
            __floats2bfloat162_rn(acc_dk[x] * scale, acc_dk[x + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vr + 8 * c) =
            __floats2bfloat162_rn(acc_dv[x], acc_dv[x + 1]);
      }
    } else {
      const long long part = (long long)nsplit * b * sk * n * E;
      float* kr = part_kv + ((long long)split * b * sk * n + row) * E + col0;
#pragma unroll
      for (int c = 0; c < E / 8; ++c) {
        const int x = 4 * c + 2 * i;
        *reinterpret_cast<float2*>(kr + 8 * c) =
            make_float2(acc_dk[x] * scale, acc_dk[x + 1] * scale);
        *reinterpret_cast<float2*>(kr + part + 8 * c) =
            make_float2(acc_dv[x], acc_dv[x + 1]);
      }
    }
  }
}

// Block (query tile x split, kv head, b): the 64 packed rows of query
// tile mt (the last tiles first: under a causal mask they see the most
// keys) over the key tiles of split `split` ([split·chunk, +chunk)) that
// they can see; writes dQ (scaled) in bf16 into dq (b, sq, h, e) when
// there is one split, else in f32 into the split's partial part_q
// (nsplit, b, sq, h, e).
template <int E>
__global__ void __launch_bounds__(kWG, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const RowInfo* __restrict__ info,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ part_q,
                   int b, int sq, int h, int n, int kv_len, int q_offset,
                   int causal, int per_tile, int mtiles, int chunk,
                   int nsplit) {
  using TL = DqTile<E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((TL::kAlign - (repro::smem_u32(smem_raw) &
                                             (TL::kAlign - 1))) &
                              (TL::kAlign - 1));
  // Q, dO resident; stage s: K, V
  auto k_tile = [&](int s) { return base + TL::kBytes * (2 + 2 * s); };
  auto v_tile = [&](int s) { return base + TL::kBytes * (3 + 2 * s); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      base + TL::kBytes * 2 * (1 + TL::kStages) + TL::kInfo * TL::kStages);
  uint64_t* qbar = bars + TL::kStages;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int split = blockIdx.x % nsplit;
  const int mt = mtiles - 1 - blockIdx.x / nsplit;
  const int kvh = blockIdx.y, bi = blockIdx.z, g = h / n;
  const int rows = per_tile * g, p0 = mt * per_tile;
  int kend = kv_len;  // one past the last key a row of the tile sees
  if (causal) kend = min(kend, q_offset + min(p0 + per_tile, sq));
  const int k_lo = split * chunk, k_hi = min(kend, k_lo + chunk);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kB - 1) / kB : 0;

  auto load_kv = [&](int j) {  // one thread: tile j into stage j % kStages
    const int s = j % TL::kStages, key0 = k_lo + j * kB;
    repro::mbar_arrive_expect_tx(&bars[s], 2 * TL::kBytes);
#pragma unroll
    for (int a = 0; a < TL::kAtoms; ++a) {
      repro::tma_load_4d(k_tile(s) + a * kB * TL::kSw, &kmap, &bars[s],
                         a * TL::kAtom, kvh, key0, bi);
      repro::tma_load_4d(v_tile(s) + a * kB * TL::kSw, &vmap, &bars[s],
                         a * TL::kAtom, kvh, key0, bi);
    }
  };
  if (t == 0) {
    for (int s = 0; s <= TL::kStages; ++s) repro::mbar_init(&bars[s], 1);
    repro::mbar_init_fence();
  }
  if (rows < kB) zero_tail<E>(base, 2, rows);
  __syncthreads();
  if (t == 0 && ntiles > 0) {
    repro::mbar_arrive_expect_tx(qbar, 2 * rows * E * 2);
#pragma unroll
    for (int a = 0; a < TL::kAtoms; ++a) {
      repro::tma_load_4d(base + a * kB * TL::kSw, &qmap, qbar, a * TL::kAtom,
                         kvh * g, p0, bi);
      repro::tma_load_4d(base + TL::kBytes + a * kB * TL::kSw, &omap, qbar,
                         a * TL::kAtom, kvh * g, p0, bi);
    }
    for (int j = 0; j < min(TL::kStages, ntiles); ++j) load_kv(j);
  }

  // this thread's two rows (16w + lane/4 and + 8) and their row data; in
  // each S/dP fragment, keys 8c + 2(lane & 3) + jj in register 4c + 2i + jj
  const int r0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  const RowInfo* info_t =
      info + (((long long)bi * n + kvh) * mtiles + mt) * kB;
  const RowInfo ri[2] = {info_t[r0], info_t[r0 + 8]};
  const float scale_log2 = kLog2e / sqrtf((float)E);
  const uint32_t q_addr = repro::smem_u32(base);
  const uint32_t o_addr = q_addr + TL::kBytes;
  float acc[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc[i] = 0.f;

  if (ntiles > 0) repro::mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % TL::kStages;
    repro::mbar_wait(&bars[s], (j / TL::kStages) & 1);
    const uint32_t k_addr = repro::smem_u32(k_tile(s));
    const uint32_t v_addr = repro::smem_u32(v_tile(s));
    const int key0 = k_lo + j * kB + col0;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    repro::wgmma_fence();
    product_ss<E>(sc, q_addr, k_addr);    // S = Q·Kᵀ
    repro::wgmma_commit();
    product_ss<E>(dp, o_addr, v_addr);    // dP = dO·Vᵀ
    repro::wgmma_commit();
    repro::wgmma_wait<1>();
    repro::fence_regs(sc);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int x = 4 * c + 2 * i + jj;
          sc[x] = key0 + 8 * c + jj < ri[i].lim
                      ? exp2f(sc[x] * scale_log2 - ri[i].lse2)
                      : 0.f;
        }
    repro::wgmma_wait<0>();
    repro::fence_regs(dp);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int x = 4 * c + 2 * i + jj;
          dp[x] = sc[x] * (dp[x] - ri[i].d);
        }
    uint32_t s_hi[4][4], s_lo[4][4];
    pack_hilo(dp, s_hi, s_lo);
    repro::wgmma_fence();
    product_rs<E>(acc, s_hi, k_addr);     // dQ += dS·K
    product_rs<E>(acc, s_lo, k_addr);
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(acc);
    __syncthreads();  // every wgmma reading stage s has completed
    if (t == 0 && j + TL::kStages < ntiles) load_kv(j + TL::kStages);
  }

  const float scale = 1.f / sqrtf((float)E);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i, pos = p0 + r / g;
    if (r >= rows || pos >= sq) continue;
    const long long row = ((long long)bi * sq + pos) * h + kvh * g + r % g;
    if (nsplit == 1) {
      __nv_bfloat16* out = dq + row * E + col0;
#pragma unroll
      for (int c = 0; c < E / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i] * scale,
                                  acc[4 * c + 2 * i + 1] * scale);
    } else {
      float* out = part_q + ((long long)split * b * sq * h + row) * E + col0;
#pragma unroll
      for (int c = 0; c < E / 8; ++c)
        *reinterpret_cast<float2*>(out + 8 * c) = make_float2(
            acc[4 * c + 2 * i] * scale, acc[4 * c + 2 * i + 1] * scale);
    }
  }
}

template <int E>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, void* dk,
                 void* dv, RowInfo* info, float* part_kv, float* part_q,
                 int b, int sq, int h, int n, int sk, int kv_len,
                 int q_offset, int causal, int per_tile, int kv_nsplit,
                 int chunk, int nsplit, cudaStream_t stream) {
  using TL = DkdvTile<E>;
  const int g = h / n;
  if (per_tile < 1 || per_tile * g > kB || kv_nsplit < 1 ||
      (kv_nsplit > 1 && part_kv == nullptr))
    return cudaErrorInvalidValue;
  const int mtiles = (sq + per_tile - 1) / per_tile;
  const CUtensorMapSwizzle sw =
      TL::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  const long long qs = (long long)h * E, ks = (long long)n * E;
  CUtensorMap qm, om, km, vm;
  int err = repro::make_map_4d(&qm, q, {E, h, sq, b}, {1, E, qs, sq * qs},
                               TL::kAtom, g, per_tile, sw);
  if (err == 0)
    err = repro::make_map_4d(&om, dout, {E, h, sq, b}, {1, E, qs, sq * qs},
                             TL::kAtom, g, per_tile, sw);
  if (err == 0)
    err = repro::make_map_4d(&km, k, {E, n, sk, b}, {1, E, ks, sk * ks},
                             TL::kAtom, 1, kB, sw);
  if (err == 0)
    err = repro::make_map_4d(&vm, v, {E, n, sk, b}, {1, E, ks, sk * ks},
                             TL::kAtom, 1, kB, sw);
  if (err != 0) return err;
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TL::kSmem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DqTile<E>::kSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long info_rows = (long long)b * n * mtiles * kB;
  constexpr int kPrepRows = 256 / (E / 8);  // rows a prep block takes
  flash_bwd_prep<E><<<(unsigned)((info_rows + kPrepRows - 1) / kPrepRows),
                      256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, info, info_rows, sq, h,
      n, per_tile, mtiles, kv_len, q_offset, causal);
  cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return e2;
  flash_bwd_dkdv_wgmma<E><<<dim3((sk + kB - 1) / kB * kv_nsplit, n, b), kWG,
                            TL::kSmem, stream>>>(
      qm, om, km, vm, info, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part_kv, b, h, n, sk, kv_len,
      q_offset, causal, per_tile, mtiles, kv_nsplit);
  e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return e2;
  if (kv_nsplit > 1) {  // row (b·sk + key)·n + kvh: the splits in order
    const long long kv_rows = (long long)b * sk * n;
    const long long part = kv_nsplit * kv_rows * E;
    e2 = sum_parts<__nv_bfloat16>(part_kv, dk, kv_rows, 1, 1, 0, kv_nsplit,
                                  kv_rows * E, E, stream);
    if (e2 != cudaSuccess) return e2;
    e2 = sum_parts<__nv_bfloat16>(part_kv + part, dv, kv_rows, 1, 1, 0,
                                  kv_nsplit, kv_rows * E, E, stream);
    if (e2 != cudaSuccess) return e2;
  }
  constexpr size_t dq_smem = DqTile<E>::kSmem;
  flash_bwd_dq_wgmma<E><<<dim3(mtiles * nsplit, n, b), kWG, dq_smem,
                          stream>>>(
      qm, om, km, vm, info, static_cast<__nv_bfloat16*>(dq), part_q, b, sq,
      h, n, kv_len, q_offset, causal, per_tile, mtiles, chunk, nsplit);
  e2 = cudaGetLastError();
  if (e2 != cudaSuccess || nsplit == 1) return e2;
  const long long rows = (long long)b * sq * h;
  return sum_parts<__nv_bfloat16>(part_q, dq, rows, 1, 1, 0, nsplit,
                                  rows * E, E, stream);
}

}  // namespace

// f32, the CUDA-core route.  q, o, dout, dq (b, sq, h, e), k, v, dk, dv
// (b, sk, n, e): contiguous f32; lse (b, h, sq) f32,
// the forward's natural-log LSE; delta (b, h, sq) f32 scratch.  Query i
// sits at q_offset + i; keys >= kv_len are masked (their dk, dv are 0);
// causal masks key j > q_offset + i.  part_kv (2, b, sk, h, e) f32
// scratch when h > n (the g query heads' dK and dV shares), part_q
// (nsplit, b, sq, h, e) f32 scratch when nsplit > 1: dQ's key range is
// split into nsplit ranges of chunk keys (a multiple of 64;
// flash_attention_bwd.py::plan).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* part_kv, void* part_q, int b, int sq, int h, int n,
    int sk, int e, int kv_len, int q_offset, int causal, int chunk,
    int nsplit, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || n < 1 ||
      h % n != 0 || kv_len < 0 || kv_len > sk || q_offset < 0 ||
      nsplit < 1 || chunk < 1 || chunk % kB != 0 ||
      (h > n && part_kv == nullptr) || (nsplit > 1 && part_q == nullptr) ||
      (long long)chunk * nsplit <
          (causal ? min(kv_len, q_offset + sq) : kv_len))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  auto pkv = static_cast<float*>(part_kv);
  auto pq = static_cast<float*>(part_q);
#define REPRO_BWD(E)                                                       \
  return launch<E>(q, k, v, o, dout, ls, dq, dk, dv, dl, pkv, pq, b, \
                          sq, h, n, sk, kv_len, q_offset, causal, chunk,   \
                          nsplit, st)
  if (e == 16) REPRO_BWD(16);
  if (e == 64) REPRO_BWD(64);
  if (e == 128) REPRO_BWD(128);
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}

// bf16, the wgmma route: q, o, dout, dq (b, sq, h, e), k, v, dk, dv (b,
// sk, n, e) contiguous bf16, 16-byte aligned (TMA); lse as above.  The
// plan is flash_attention_bwd.py::wgmma_plan's: per_tile query positions
// (of the g heads) in a 64-row tile, h/n <= 64; the dK/dV pass's query
// tiles split kv_nsplit ways, dQ's keys in nsplit ranges of chunk (a
// multiple of 64).  info (b, n, mtiles, 64) RowInfo (16 bytes each)
// scratch, mtiles = ceil(sq / per_tile); part_kv (2, kv_nsplit, b, sk,
// n, e) f32 scratch when kv_nsplit > 1, part_q (nsplit, b, sq, h, e) when
// nsplit > 1.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* info, void* part_kv, void* part_q, int b, int sq, int h, int n,
    int sk, int e, int kv_len, int q_offset, int causal, int per_tile,
    int kv_nsplit, int chunk, int nsplit, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || n < 1 || h % n != 0 || kv_len < 0 ||
      kv_len > sk || q_offset < 0 || nsplit < 1 || chunk < 1 ||
      chunk % kB != 0 || (nsplit > 1 && part_q == nullptr) ||
      (long long)chunk * nsplit <
          (causal ? min(kv_len, q_offset + sq) : kv_len))
    return cudaErrorInvalidValue;
#define REPRO_BWD(E)                                                        \
  return launch_wgmma<E>(q, k, v, o, dout, static_cast<const float*>(lse),  \
                         dq, dk, dv, static_cast<RowInfo*>(info),           \
                         static_cast<float*>(part_kv),                      \
                         static_cast<float*>(part_q), b, sq, h, n, sk,      \
                         kv_len, q_offset, causal, per_tile, kv_nsplit,     \
                         chunk, nsplit, static_cast<cudaStream_t>(stream))
  if (e == 16) REPRO_BWD(16);
  if (e == 64) REPRO_BWD(64);
  if (e == 128) REPRO_BWD(128);
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}
