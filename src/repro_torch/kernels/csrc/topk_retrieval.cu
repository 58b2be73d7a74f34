// K3 — fused inner-product scoring + top-k for the vector-search stage.
//
// Replaces the TPU kernel repro/kernels/topk_retrieval.py::_topk_kernel
// (pallas_call at topk_retrieval.py:58).
//
// What bounds it on the H100: device-memory bytes.  Each corpus row (d f32)
// is read once and scored against nq <= 16 queries: 2*nq flops per 4
// bytes, far under the f32 ridge, so the scores stay exact f32 FMAs on the
// CUDA cores (TF32 products would change ids on near-ties, and the tensor
// cores buy nothing here).  What the design does about it:
//  * every shape is spread over the SMs: the corpus is cut into tiles of
//    R = 8, 16 or 32 rows, each row scored by 256/R lanes (a whole warp per
//    row at R = 8) and folded by a tree, as the plain product's GEMV does
//    at nq = 1; or, for nq >= 2 once the corpus has a 256-row tile for
//    every SM, of 256 rows with one thread per row summing it over d in
//    order, as the plain product's GEMM does, so large scores agree to the
//    last bits.  The tiles are split across blocks so the grid holds as
//    close to two blocks per SM as whole tiles allow in one wave
//    (kernels/topk_retrieval.py::split_plan picks R and the split); the
//    query tile is sized to nq, so no block scores empty query rows;
//  * the corpus streams through a cp.async ring of 16-byte copies, each
//    stage R rows of 8, 16 or 32 KB in all with the queries' matching
//    features, so the next chunk loads while the current one is
//    multiplied; each step pays a barrier, so the plan takes the largest
//    stages that leave two blocks per SM, 2 or 3 deep; each corpus byte is
//    read once, and no (nq, N) score matrix is written;
//  * selection without a full sort: each query keeps its running top-k
//    list and its k-th best as a threshold; a scored row that beats it is
//    appended to a small candidate buffer (compacted with a warp ballot),
//    and the buffer is merged into the list only when it fills.  A merge
//    is one warp per query: the candidates, as 64-bit keys that order like
//    the answer, sorted in registers by a bitonic network of shuffles,
//    then folded into the sorted list (a bitonic merge), with no
//    __syncthreads.  A split of no more rows than
//    k skips selection and hands its scores on as they are;
//  * topk_merge folds the splits' lists per query the same way: a lane
//    walks one split's sorted list and stops at its first entry that does
//    not beat the warp's threshold (seeded with the k-th best of its
//    lists' heads, a lower bound of the answer's k-th), the warps' buffers
//    are merged in registers, and warp 0 merges the entries of the warps'
//    lists that are at least as good as the best warp's k-th.  At the
//    vector DB's k = 112 of 128 rows (16 splits of 8 raw scores) that is
//    one warp sorting 128 scores, 4 per lane.
// Order: values descending, ties to the lower corpus index, as
// jax.lax.top_k (topk_retrieval.py:42).  Rows >= N never enter.  k <= 256.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // threads of a scoring block
constexpr int kMaxStages = 3;  // ring depth: 2 or 3, planned per call
constexpr int kBuf = 256;      // candidate buffer per query: >= R
constexpr unsigned kFull = 0xffffffffu;

// -- keys --------------------------------------------------------------------
// An entry (value, index) as one 64-bit key that orders as the answer does:
// a larger key is a larger value, or the same value at a lower index.  The
// high word is the value's bits made monotone (-0 counts as +0), the low
// word the index reversed.  A compare-exchange is then a u64 min/max.
typedef unsigned long long Key;
constexpr Key kNone = 0;  // below every entry: empty slots

__device__ __forceinline__ Key make_key(float v, int i) {
  unsigned u = __float_as_uint(v + 0.f);  // -0 + 0 = +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)u << 32) | (0xFFFFFFFFu - (unsigned)i);
}
__device__ __forceinline__ float key_value(Key k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}
__device__ __forceinline__ int key_index(Key k) {
  return (int)(0xFFFFFFFFu - (unsigned)k);
}

// -- warp-wide sorting in registers ------------------------------------------
// A warp holds 32*P keys, entry e = lane*P + p in register p of `lane`.

// one compare-exchange step of a bitonic network: blocks of `size`, partner
// at distance j; every block ends largest-first once its merge is done
template <int P>
__device__ __forceinline__ void bitonic_step(Key (&k)[P], int size, int j,
                                             int lane) {
  if (j < P) {  // the partner is in this lane's registers
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = p ^ j;
      if (q > p) {
        const bool up = ((lane * P + p) & size) == 0;
        const Key hi = k[p] > k[q] ? k[p] : k[q];
        const Key lo = k[p] > k[q] ? k[q] : k[p];
        k[p] = up ? hi : lo;
        k[q] = up ? lo : hi;
      }
    }
  } else {  // the partner is register p of lane ^ (j / P)
    const int lm = j / P;
    const bool lower = (lane & lm) == 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const Key o = __shfl_xor_sync(kFull, k[p], lm);
      const bool up = ((lane * P + p) & size) == 0;
      k[p] = (lower == up) ? (o > k[p] ? o : k[p]) : (o > k[p] ? k[p] : o);
    }
  }
}

template <int P>
__device__ __forceinline__ void warp_sort(Key (&k)[P], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * P; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) bitonic_step<P>(k, size, j, lane);
  }
}

// Folds n keys (any order, in memory) into the sorted list `best`: each
// chunk of 32*P is sorted, reversed against the list, the larger of each
// pair kept (a bitonic sequence that holds the best 32*P of both), and
// merged largest-first.
template <int P>
__device__ void warp_merge(Key (&best)[P], const Key* cand, int n,
                           int lane) {
  for (int c0 = 0; c0 < n; c0 += 32 * P) {
    Key k[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int e = c0 + lane * P + p;
      k[p] = e < n ? cand[e] : kNone;
    }
    warp_sort<P>(k, lane);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const Key r = __shfl_xor_sync(kFull, k[P - 1 - p], 31);
      best[p] = r > best[p] ? r : best[p];
    }
#pragma unroll
    for (int j = 16 * P; j > 0; j >>= 1) bitonic_step<P>(best, 32 * P, j, lane);
  }
}

// entry e of the warp's sorted list, broadcast to every lane
template <int P>
__device__ __forceinline__ Key warp_entry(const Key (&best)[P], int e) {
  Key x = best[0];
#pragma unroll
  for (int p = 1; p < P; ++p) x = (p == e % P) ? best[p] : x;
  return __shfl_sync(kFull, x, e / P);
}

// -- cp.async ----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// at most n groups still in flight (wait_group takes an immediate)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n == 0)
    cp_async_wait<0>();
  else
    cp_async_wait<1>();
}

// -- scoring and per-split selection -----------------------------------------

// Scores corpus rows [split*rows_per, min(N, +rows_per)) against queries
// [blockIdx.x*QT, +QT) and writes kk entries per query to part (nq,
// nsplit, kk).  With more rows than k (`select`) they are the split's k
// best, sorted; otherwise (kk == rows_per) the rows' scores as they are,
// padded with (-inf, INT_MAX) past the last row.
//
// Shared memory: the ring of `stages` stages, each R corpus rows of DC
// floats (rows padded by 4 floats against bank conflicts) and the QT
// queries' same DC features; then, when selecting, per query the sorted
// list (32P keys), the candidate buffer (kBuf keys), the threshold (the
// list's k-th key) and the buffer's fill count.  Thread t scores row t / G
// of a tile over the features (4 * (t % G + G * u), +4) of each chunk.
template <int QT, int P>
__global__ void __launch_bounds__(kThreads)
topk_partial(const float* __restrict__ queries,
             const float* __restrict__ corpus, float* __restrict__ part_v,
             int* __restrict__ part_i, int nq, int N, int d, int k, int R,
             int rows_per, int nsplit, int kk, int stage_floats,
             int stages) {
  extern __shared__ __align__(16) float smem[];
  // G lanes per row, DC features of each row per stage, U float4 of them
  // per thread
  const int G = kThreads / R, DC = stage_floats / R;
  const int U = stage_floats / (4 * kThreads);
  const int pitch = DC + 4, stage = R * pitch + QT * DC;
  constexpr int L = 32 * P;
  Key* list = reinterpret_cast<Key*>(smem + stages * stage);
  Key* buf = list + QT * L;
  Key* thr = buf + QT * kBuf;
  int* count = reinterpret_cast<int*>(thr + QT);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int qt0 = blockIdx.x * QT, split = blockIdx.y;
  const int row_lo = split * rows_per;
  const int row_hi = min(N, row_lo + rows_per);
  const int nrows = max(0, row_hi - row_lo);
  const int ntile = (nrows + R - 1) / R, nchunk = (d + DC - 1) / DC;
  const int nsteps = ntile * nchunk;
  const int rr = t / G, sl = t % G;
  const bool select = rows_per > k;

  if (select) {
    for (int i = t; i < QT * L; i += kThreads) list[i] = kNone;
    for (int q = t; q < QT; q += kThreads) {
      count[q] = 0;
      thr[q] = kNone;
    }
  } else {
    for (int i = t; i < QT * (kk - nrows); i += kThreads) {
      const int q = i / (kk - nrows), slot = nrows + i % (kk - nrows);
      if (qt0 + q < nq) {
        const long long o = ((long long)(qt0 + q) * nsplit + split) * kk + slot;
        part_v[o] = -CUDART_INF_F;
        part_i[o] = INT_MAX;
      }
    }
  }

  // step s = (tile s / nchunk, chunk s % nchunk) into stage s % stages;
  // a group is committed for every step, empty past the last
  auto issue = [&](int s) {
    if (s < nsteps) {
      const int r0 = row_lo + (s / nchunk) * R, d0 = (s % nchunk) * DC;
      float* cs = smem + (s % stages) * stage;
      float* qs = cs + R * pitch;
      const int f4 = DC / 4;
      for (int f = t; f < R * f4; f += kThreads) {
        const int row = f / f4, c = 4 * (f % f4);
        const bool ok = r0 + row < row_hi && d0 + c < d;
        cp_async16(cs + row * pitch + c,
                   ok ? corpus + (long long)(r0 + row) * d + d0 + c : corpus,
                   ok);
      }
      for (int f = t; f < QT * f4; f += kThreads) {
        const int q = f / f4, c = 4 * (f % f4);
        const bool ok = qt0 + q < nq && d0 + c < d;
        cp_async16(qs + q * DC + c,
                   ok ? queries + (long long)(qt0 + q) * d + d0 + c
                      : queries,
                   ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) issue(s);

  float acc[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) acc[q] = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_n(stages - 2);
    __syncthreads();  // stage s has landed; stage s - 1 is consumed
    issue(s + stages - 1);
    const float* cs = smem + (s % stages) * stage;
    const float* qs = cs + R * pitch;
    for (int u = 0; u < U; ++u) {
      const int c = 4 * (sl + G * u);
      const float4 x = *reinterpret_cast<const float4*>(cs + rr * pitch + c);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(qs + q * DC + c);
        float a = acc[q];
        a = fmaf(x.x, y.x, a);
        a = fmaf(x.y, y.y, a);
        a = fmaf(x.z, y.z, a);
        a = fmaf(x.w, y.w, a);
        acc[q] = a;
      }
    }
    if (s % nchunk != nchunk - 1) continue;

    // the row tile is scored: fold the G lanes of each row
    const int tile = s / nchunk, row = row_lo + tile * R + rr;
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      for (int o = G >> 1; o > 0; o >>= 1)
        acc[q] += __shfl_xor_sync(kFull, acc[q], o);
    }
    const bool real = sl == 0 && row < row_hi;
    if (!select) {
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        if (real && qt0 + q < nq) {
          const long long o =
              ((long long)(qt0 + q) * nsplit + split) * kk + row - row_lo;
          part_v[o] = acc[q];
          part_i[o] = row;
        }
      }
    } else {
      // rows that beat their query's threshold join its buffer
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const Key key = make_key(acc[q], row);
        const bool beats = real && qt0 + q < nq && key > thr[q];
        const unsigned mask = __ballot_sync(kFull, beats);
        if (mask) {
          const int leader = __ffs(mask) - 1;
          int base = 0;
          if (lane == leader) base = atomicAdd(&count[q], __popc(mask));
          base = __shfl_sync(kFull, base, leader);
          if (beats)
            buf[q * kBuf + base + __popc(mask & ((1u << lane) - 1))] = key;
        }
      }
      __syncthreads();
      // a buffer that could not take the next tile, or the last tile's,
      // is merged into its list by one warp
      const bool last = tile == ntile - 1;
      for (int q = warp; q < QT; q += kThreads / 32) {
        const int n = count[q];
        if (n > kBuf - R || (last && n > 0)) {
          Key best[P];
#pragma unroll
          for (int p = 0; p < P; ++p) best[p] = list[q * L + lane * P + p];
          warp_merge<P>(best, buf + q * kBuf, n, lane);
#pragma unroll
          for (int p = 0; p < P; ++p) list[q * L + lane * P + p] = best[p];
          const Key kth = warp_entry<P>(best, k - 1);
          if (lane == 0) {
            thr[q] = kth;
            count[q] = 0;
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[q] = 0.f;
  }
  if (select) {
    for (int i = t; i < QT * k; i += kThreads) {
      const int q = i / k, j = i % k;
      if (qt0 + q < nq) {
        const long long o = ((long long)(qt0 + q) * nsplit + split) * kk + j;
        const Key key = list[q * L + j];
        part_v[o] = key == kNone ? -CUDART_INF_F : key_value(key);
        part_i[o] = key == kNone ? INT_MAX : key_index(key);
      }
    }
  }
}

// -- the split merge ---------------------------------------------------------

// One block per query, blockDim.x / 32 warps.  The partial entries are
// nsplit lists of kk.  Sorted lists (each split's k best): lane l of warp w
// walks list 32w + l from its head and stops at the first entry that does
// not beat the warp's running k-th best, since none after it can; that
// threshold starts from a lower bound of the answer's k-th best.
// Unsorted lists (a split's raw scores): warp w scans its share of all
// entries.  Either way a warp buffers the entries that beat its threshold
// and merges the buffer into its list (in registers) when it fills; then
// warp 0 merges what of the warps' lists can still be among the k best,
// and writes them.
template <int P>
__global__ void topk_merge(const float* __restrict__ part_v,
                           const int* __restrict__ part_i,
                           float* __restrict__ out_v, int* __restrict__ out_i,
                           int k, int nsplit, int kk, int sorted) {
  extern __shared__ __align__(16) float msm[];
  constexpr int L = 32 * P, cap = L + 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  // shared memory: each warp's buffer, then the union of the warps' lists
  Key* wb = reinterpret_cast<Key*>(msm) + warp * cap;
  Key* uni = reinterpret_cast<Key*>(msm) + W * cap;
  const long long q = blockIdx.x;
  const int n_cand = nsplit * kk;
  const float* pv = part_v + q * n_cand;
  const int* pi = part_i + q * n_cand;
  auto load = [&](long long e) { return make_key(pv[e], pi[e]); };

  Key best[P];
#pragma unroll
  for (int p = 0; p < P; ++p) best[p] = kNone;
  // the threshold only rises; the seed is let through
  Key thr = kNone, seed = kNone;
  int nbuf = 0;
  // one candidate per lane per round, buffered if it beats the threshold
  auto offer = [&](bool has, Key key) {
    const bool beats = has && (key > thr || (key == seed && seed != kNone));
    const unsigned mask = __ballot_sync(kFull, beats);
    if (beats) wb[nbuf + __popc(mask & ((1u << lane) - 1))] = key;
    nbuf += __popc(mask);
    __syncwarp();
    if (nbuf > L) {
      warp_merge<P>(best, wb, nbuf, lane);
      nbuf = 0;
      const Key kth = warp_entry<P>(best, k - 1);
      thr = kth > thr ? kth : thr;
      __syncwarp();
    }
    return beats;
  };
  if (sorted) {
    // Seed the threshold with a lower bound of the k-th best: the k-th
    // best of the first m entries of this warp's lists (32 m >= k).  An
    // entry worse than it has k better ones, so it cannot be among the k
    // best; the seed itself may be, and is let through.
    const int s = warp * 32 + lane;
    const int m = (k + 31) / 32;
    for (int j = 0; j < m; ++j)
      wb[j * 32 + lane] = s < nsplit ? load((long long)s * kk + j) : kNone;
    __syncwarp();
    warp_merge<P>(best, wb, 32 * m, lane);
    thr = seed = warp_entry<P>(best, k - 1);
#pragma unroll
    for (int p = 0; p < P; ++p) best[p] = kNone;
    __syncwarp();
    int pos = s < nsplit ? 0 : kk;
    while (__any_sync(kFull, pos < kk)) {
      const bool has = pos < kk;
      const bool beats =
          offer(has, has ? load((long long)s * kk + pos) : kNone);
      pos = beats ? pos + 1 : kk;
    }
  } else {
    const int per = (n_cand + W - 1) / W;
    const int lo = warp * per, hi = min(n_cand, lo + per);
    for (int base = lo; base < hi; base += 32) {
      const int e = base + lane;
      offer(e < hi, e < hi ? load(e) : kNone);
    }
  }
  if (nbuf > 0) warp_merge<P>(best, wb, nbuf, lane);

  if (W > 1) {
    // Fold the warps' lists: the best of the warps' k-th entries is a
    // lower bound of the answer's k-th, so only list entries at least as
    // good enter the union, which warp 0 merges.
    __shared__ Key kth[32];
    __shared__ int n_union;
    const Key mine = warp_entry<P>(best, k - 1);
    if (lane == 0) kth[warp] = mine;
    if (threadIdx.x == 0) n_union = 0;
    __syncthreads();
    Key bound = kth[0];
    for (int w = 1; w < W; ++w) bound = kth[w] > bound ? kth[w] : bound;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool keep = best[p] != kNone && best[p] >= bound;
      const unsigned mask = __ballot_sync(kFull, keep);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(&n_union, __popc(mask));
      base = __shfl_sync(kFull, base, 0);
      if (keep) uni[base + __popc(mask & ((1u << lane) - 1))] = best[p];
    }
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int p = 0; p < P; ++p) best[p] = kNone;
    warp_merge<P>(best, uni, n_union, lane);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int e = lane * P + p;
    if (e < k) {
      out_v[q * k + e] = key_value(best[p]);
      out_i[q * k + e] = key_index(best[p]);
    }
  }
}

template <int QT, int P>
int launch(const float* queries, const float* corpus, float* part_v,
           int* part_i, float* out_v, int* out_i, int nq, int N, int d,
           int k, int R, int rows_per, int nsplit, int kk, int sf,
           int stages, int mwarps, cudaStream_t st) {
  constexpr int L = 32 * P;
  const int DC = sf / R;
  size_t smem = sizeof(float) * stages * (R * (DC + 4) + QT * DC);
  if (rows_per > k)
    smem += sizeof(float) * QT * (2 * L + 2 * kBuf + 3);
  constexpr int kMaxSmem = 200 * 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      topk_partial<QT, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return attr;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  topk_partial<QT, P><<<dim3((nq + QT - 1) / QT, nsplit), kThreads, smem,
                        st>>>(queries, corpus, part_v, part_i, nq, N, d, k,
                              R, rows_per, nsplit, kk, sf, stages);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // per warp its buffer, then the union of the warps' lists
  const size_t msmem = sizeof(float) * mwarps * (2 * (L + 32) + 2 * L);
  static const cudaError_t mattr = cudaFuncSetAttribute(
      topk_merge<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, 96 * 1024);
  if (mattr != cudaSuccess) return mattr;
  topk_merge<P><<<nq, 32 * mwarps, msmem, st>>>(
      part_v, part_i, out_v, out_i, k, nsplit, kk, rows_per > k);
  return cudaGetLastError();
}

}  // namespace

// queries (nq,d) and corpus (N,d) row-major f32, d % 4 == 0, 16-byte
// aligned.  The plan (qt, R, rows_per, nsplit, kk, P, sf, stages, mwarps) is
// topk_retrieval.py::split_plan's; part_v/part_i are (nq, nsplit, kk)
// scratch, out_v/out_i (nq, k).
extern "C" int repro_topk_retrieval(const void* queries, const void* corpus,
                                    void* part_v, void* part_i, void* out_v,
                                    void* out_i, int nq, int N, int d, int k,
                                    int qt, int R, int rows_per, int nsplit,
                                    int kk, int P, int sf, int stages,
                                    int mwarps, void* stream) {
  if (k < 1 || k > 32 * P || P > 8 || d % 4 != 0 ||
      (R != 8 && R != 16 && R != 32 && R != 256) || rows_per % R != 0 ||
      kk != (rows_per > k ? k : rows_per) || mwarps < 1 || mwarps > 16 ||
      stages < 2 || stages > kMaxStages ||
      (sf != 2048 && sf != 4096 && sf != 8192))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(queries);
  auto cp = static_cast<const float*>(corpus);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  auto ov = static_cast<float*>(out_v);
  auto oi = static_cast<int*>(out_i);
#define REPRO_TOPK_P(QT, PP)                                                \
  if (P == PP)                                                              \
  return launch<QT, PP>(qp, cp, pv, pi, ov, oi, nq, N, d, k, R, rows_per,   \
                        nsplit, kk, sf, stages, mwarps, st)
#define REPRO_TOPK(QT)                                                      \
  if (qt == QT) {                                                           \
    REPRO_TOPK_P(QT, 1);                                                    \
    REPRO_TOPK_P(QT, 2);                                                    \
    REPRO_TOPK_P(QT, 4);                                                    \
    REPRO_TOPK_P(QT, 8);                                                    \
  }
  REPRO_TOPK(1)
  REPRO_TOPK(2)
  REPRO_TOPK(4)
  REPRO_TOPK(8)
  REPRO_TOPK(16)
#undef REPRO_TOPK
#undef REPRO_TOPK_P
  return cudaErrorInvalidValue;
}
