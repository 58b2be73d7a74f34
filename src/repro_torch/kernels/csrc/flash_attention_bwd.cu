// K2's backward — the gradients of GQA flash attention, four kernels.
//
// The JAX package has no backward Pallas kernel: it differentiates the jnp
// attention repro/models/layers.py::mha (layers.py:116) with XLA's
// autodiff.  This is the port's hand-written counterpart of that
// gradient, for the forward of flash_attention.cu (flash_fwd_wgmma in
// bf16, flash_fwd in f32) without window or MLA mode: GQA (h % n == 0),
// causal or not, query i at position q_offset + i, keys >= kv_len masked,
// e in {16, 64, 128}, bf16 or f32 inputs, f32 accumulators.
//
// With P = exp(S·scale - lse) recomputed from the forward's LSE (natural
// log, f32 (b, h, sq)), scale = 1/sqrt(e):
//   D  = rowsum(dO ⊙ O)                                 flash_bwd_delta
//   dV = Pᵀ·dO,  dK = dSᵀ·Q·scale, summed over the g query heads of each kv
//   head, with dP = dO·Vᵀ and dS = P ⊙ (dP - D)         flash_bwd_dkdv
//   dQ = dS·K·scale                                     flash_bwd_dq
//   shares and splits added in a fixed order            flash_bwd_sum
// Two passes with no float atomics: a dK/dV block owns 64 keys of one
// query head and walks its query tiles, a dQ block owns 64 query rows and
// walks a range of key tiles, so S and dP are computed in both (7 products
// of 64 x 64 tiles where 5 would do).  Where a kv head serves g > 1 query
// heads, each dK/dV block writes its head's share in f32 and
// flash_bwd_sum adds the g shares in head order; where the dQ grid would
// leave the card half idle (few query rows, e.g. 16 queries over 1601
// keys), the key range is split (kernels/flash_attention_bwd.py::plan)
// and flash_bwd_sum adds the splits' f32 partials in split order.  So
// every gradient is the same from run to run.
//
// What bounds it on the H100: at the training shape (b 8, 256 positions,
// 16 heads of 64, causal) the inputs and outputs are 8 tensors of 4.2 MB
// (about 10 µs at 3.35 TB/s) and the 5 products about 2.7 GFLOP (2.7 µs
// on the bf16 tensor cores), so bytes bound it.  This first version runs
// on the CUDA cores in f32 (tiles staged in shared memory as f32, a
// 16 x 16 thread grid, each thread a 4 x 4 patch of a 64 x 64 product), so
// it is bound by its FMAs instead; wgmma and TMA are later work.
#include "common.cuh"

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
template <typename T, int E>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int nrows) {
  for (int i = threadIdx.x; i < kB * E; i += kThreads) {
    const int r = i / E, c = i % E;
    dst[r * (E + 1) + c] =
        r0 + r < nrows ? repro::to_f(src[(long long)(r0 + r) * row_stride + c])
                       : 0.f;
  }
}

// D = rowsum(dO ⊙ O) in f32, one warp a row of (b, sq, h) -> delta
// (b, h, sq)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int sq, int h,
                int e) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp: one row per warp
  float s = 0.f;
  for (int j = lane; j < e; j += 32)
    s += repro::to_f(o[row * e + j]) * repro::to_f(dout[row * e + j]);
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
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ part_dk,
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
    const T* kb = k + (long long)bi * sk * krow + kvh * E;
    const T* vb = v + (long long)bi * sk * krow + kvh * E;
    load_tile<T, E>(ks, kb, krow, k0, kv_len);
    load_tile<T, E>(vs, vb, krow, k0, kv_len);
    {
      const T* qb = q + (long long)bi * sq * qrow + hh * E;
      const T* ob = dout + (long long)bi * sq * qrow + hh * E;
      const long long lrow = ((long long)bi * h + hh) * sq;
      for (int q0 = i_lo / kB * kB; q0 < sq; q0 += kB) {
        __syncthreads();  // the previous tile's reads are done
        load_tile<T, E>(qs, qb, qrow, q0, sq);
        load_tile<T, E>(dos, ob, qrow, q0, sq);
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
        dk[at + tx + 16 * c] = repro::from_f<T>(acc_dk[x][c] * scale);
        dv[at + tx + 16 * c] = repro::from_f<T>(acc_dv[x][c]);
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
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, float* __restrict__ part_dq, int b, int sq,
             int h, int n, int sk, int kv_len, int q_offset, int causal,
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

  load_tile<T, E>(qs, q + (long long)bi * sq * qrow + hh * E, qrow, q0, sq);
  load_tile<T, E>(dos, dout + (long long)bi * sq * qrow + hh * E, qrow, q0,
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
  const T* kb = k + (long long)bi * sk * krow + kvh * E;
  const T* vb = v + (long long)bi * sk * krow + kvh * E;
  for (int k0 = split * chunk; k0 < kend; k0 += kB) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, E>(ks, kb, krow, k0, kv_len);
    load_tile<T, E>(vs, vb, krow, k0, kv_len);
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
        dq[at + tx + 16 * c] = repro::from_f<T>(acc[x][c] * scale);
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

template <typename T, int E>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, float* part_kv, float* part_q, int b, int sq, int h,
           int n, int sk, int kv_len, int q_offset, int causal, int chunk,
           int nsplit, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<E>();
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)b * sq * h;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows, sq, h, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)E);
  const int g = h / n;
  const long long kv_part = (long long)b * sk * h * E;  // one share array
  flash_bwd_dkdv<T, E><<<dim3((sk + kB - 1) / kB, h, b), kThreads, smem,
                         stream>>>(qt, kt, vt, dot, lse, delta,
                                   static_cast<T*>(dk), static_cast<T*>(dv),
                                   part_kv, g > 1 ? part_kv + kv_part : nullptr,
                                   sq, h, n, sk, kv_len, q_offset, causal,
                                   scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (g > 1) {  // dk, dv row (b·sk + key, kvh) = sum of shares kvh·g + j
    const long long kv_rows = (long long)b * sk * n;
    err = sum_parts<T>(part_kv, dk, kv_rows, n, h, g, g, E, E, stream);
    if (err != cudaSuccess) return err;
    err = sum_parts<T>(part_kv + kv_part, dv, kv_rows, n, h, g, g, E, E,
                       stream);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq<T, E><<<dim3((sq + kB - 1) / kB * nsplit, h, b), kThreads,
                       smem, stream>>>(qt, kt, vt, dot, lse, delta,
                                       static_cast<T*>(dq), part_q, b, sq, h,
                                       n, sk, kv_len, q_offset, causal, scale,
                                       chunk, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  // dq row r (of the b·sq·h rows) = the sum over splits s of part_q[s]'s
  return sum_parts<T>(part_q, dq, rows, 1, 1, 0, nsplit, rows * E, E,
                      stream);
}

}  // namespace

// q, o, dout, dq (b, sq, h, e), k, v, dk, dv (b, sk, n, e): contiguous, of
// one dtype (0 f32, 1 bf16); lse (b, h, sq) f32, the forward's
// natural-log LSE; delta (b, h, sq) f32 scratch.  Query i sits at
// q_offset + i; keys >= kv_len are masked (their dk, dv are 0); causal
// masks key j > q_offset + i.  part_kv (2, b, sk, h, e) f32 scratch when
// h > n (the g query heads' dK and dV shares), part_q (nsplit, b, sq, h,
// e) f32 scratch when nsplit > 1: dQ's key range is split into nsplit
// ranges of chunk keys (a multiple of 64; flash_attention_bwd.py::plan).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* part_kv, void* part_q, int dtype, int b, int sq,
    int h, int n, int sk, int e, int kv_len, int q_offset, int causal,
    int chunk, int nsplit, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || n < 1 || h % n != 0 || kv_len < 0 ||
      kv_len > sk || q_offset < 0 || nsplit < 1 || chunk < 1 ||
      chunk % kB != 0 || (h > n && part_kv == nullptr) ||
      (nsplit > 1 && part_q == nullptr) ||
      (long long)chunk * nsplit <
          (causal ? min(kv_len, q_offset + sq) : kv_len))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  auto pkv = static_cast<float*>(part_kv);
  auto pq = static_cast<float*>(part_q);
#define REPRO_BWD(T, E)                                                    \
  return launch<T, E>(q, k, v, o, dout, ls, dq, dk, dv, dl, pkv, pq, b, sq, \
                      h, n, sk, kv_len, q_offset, causal, chunk, nsplit, st)
  if (dtype == repro::kBF16) {
    if (e == 16) REPRO_BWD(__nv_bfloat16, 16);
    if (e == 64) REPRO_BWD(__nv_bfloat16, 64);
    if (e == 128) REPRO_BWD(__nv_bfloat16, 128);
  } else if (dtype == repro::kF32) {
    if (e == 16) REPRO_BWD(float, 16);
    if (e == 64) REPRO_BWD(float, 64);
    if (e == 128) REPRO_BWD(float, 128);
  }
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}
