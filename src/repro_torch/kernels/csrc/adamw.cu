// AdamW over every leaf of a model in one pass: a multi-tensor kernel pair.
//
// Replaces no TPU kernel.  The JAX package leaves AdamW
// (repro/training/optimizer.py::adamw_update) to XLA, which fuses each
// leaf's arithmetic into one loop.  The port's plain version is the
// per-leaf loop of torch operations in training/optimizer.py: about 28
// passes a leaf, each a launch and a full round trip through f32
// temporaries.  This kernel pair does the same arithmetic in one pass.
//
// What bounds it on the H100: bytes.  Per parameter the update reads p, g,
// m and v and writes p, m and v: 2 + 2 + 4 + 4 read and 2 + 4 + 4 written
// at bf16 parameters and gradients and f32 moments, 22 bytes, and the
// global norm reads g once more, 2 bytes: 24 bytes against 19 f32
// operations, far under the ridge.  What the design does about it:
//  * two launches for the whole model, whatever its number of leaves (up
//    to kMaxLeaves a launch): adamw_sumsq sums the squares of every
//    gradient, adamw_step folds those sums into the clip scale and updates
//    every leaf.  The leaves are described by one table passed by value
//    (pointers, element counts, types and tile prefix sums: about 24 KB of
//    kernel parameters, which Hopper takes since CUDA 12.1), so nothing is
//    copied to the device or allocated per call;
//  * every leaf is cut into tiles of kTile elements, and the blocks walk
//    the flat tile list in grid-stride order, so a 2,048-element norm
//    scale and a 311 M-element embedding table share the SMs evenly; a
//    tile finds its leaf by a binary search over the prefix sums;
//  * each element is read once and written once, by 16-byte vector loads
//    and stores where a leaf's four arrays are 16-byte aligned, with a
//    masked scalar tail; the update lives in registers, so no temporary
//    touches device memory;
//  * the norm's sums leave no atomics: each block of adamw_sumsq writes
//    one partial sum (f32 squares summed a tile at a time, the tiles in
//    f64), and every block of adamw_step folds all partials in the same
//    fixed order, so all blocks see the same norm and two runs are
//    bit-equal.
// Arithmetic: the plain loop's, operation for operation and in its order,
// each rounded once to f32 by the _rn intrinsics, so nvcc contracts
// nothing into an FMA that the loop does not do:
//   g = g*scale
//   m1 = b1*m + (1-b1)*g
//   v1 = b2*v + (1-b2)*(g*g)
//   delta = (m1/bc1) / (sqrt(v1/bc2) + eps) + wd*p
//   p = p - lr*delta
// and p, m, v each rounded to nearest-even into their own type.  The clip
// scale is torch's clamp(clip * (1 / clamp(gnorm, min=floor)), max=1),
// NaN kept as clamp keeps it.  lr, bc1 and bc2 are read from the device,
// where the optimizer's schedule left them, so the host never waits.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 512;  // leaves a launch (kernels/adamw.py)
constexpr int kThreads = 256;
constexpr int kVec = 8;          // elements a thread moves per vector step
constexpr int kTile = 8192;      // elements of a tile: 4 vector steps
static_assert(kTile % (kThreads * kVec) == 0, "whole vector steps a tile");

// leaf codes (kernels/adamw.py::leaf_code)
constexpr int kPBf16 = 1, kGBf16 = 2, kSBf16 = 4, kAligned = 8;

struct Leaves {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int code[kMaxLeaves];
  int tile0[kMaxLeaves + 1];  // tile0[i]: the first tile of leaf i
  int count;
};

struct Hyper {
  const float* lr;
  const float* bc1;
  const float* bc2;
  float b1, c1, b2, c2, eps, wd, clip, floor;
};

// -- loads and stores of 8 elements as f32 -----------------------------------
__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// -- the tile walk ------------------------------------------------------------
// The leaf of tile t: the largest i with tile0[i] <= t (a leaf of no
// elements has no tiles and is passed over).
__device__ __forceinline__ int leaf_of(const Leaves& L, int t) {
  int lo = 0, hi = L.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.tile0[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct Tile {
  int leaf;
  long long e0;  // first element
  int count;     // elements, at most kTile
};

__device__ __forceinline__ Tile tile_at(const Leaves& L, int t) {
  const int l = leaf_of(L, t);
  const long long e0 = (long long)(t - L.tile0[l]) * kTile;
  const long long left = L.n[l] - e0;
  return {l, e0, left < kTile ? (int)left : kTile};
}

__device__ __forceinline__ double block_sum(double x, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? red[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
}

// -- the norm ----------------------------------------------------------------
template <typename G>
__device__ __forceinline__ float sumsq_tile(const G* g, int count,
                                            bool aligned) {
  float s = 0.f;
  int done = 0;
  if (aligned) {
    done = count / kVec * kVec;
    // every vector step of the tile loaded before any is summed
    constexpr int kSteps = kTile / (kThreads * kVec);
    float x[kSteps][kVec];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int i = (k * kThreads + threadIdx.x) * kVec;
      if (i < done) load8(g + i, x[k]);
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int i = (k * kThreads + threadIdx.x) * kVec;
      if (i < done) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) s += x[k][j] * x[k][j];
      }
    }
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) {
    const float x = repro::to_f(g[i]);
    s += x * x;
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
adamw_sumsq(const Leaves L, double* __restrict__ partials) {
  __shared__ double red[kThreads / 32];
  double acc = 0.0;
  const int tiles = L.tile0[L.count];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile T = tile_at(L, t);
    const int code = L.code[T.leaf];
    const bool aligned = code & kAligned;
    if (code & kGBf16)
      acc += sumsq_tile(static_cast<const __nv_bfloat16*>(L.g[T.leaf]) + T.e0,
                        T.count, aligned);
    else
      acc += sumsq_tile(static_cast<const float*>(L.g[T.leaf]) + T.e0,
                        T.count, aligned);
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// -- the update --------------------------------------------------------------
struct Step {
  float scale, lr, bc1, bc2;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h, const Step& s) {
  g = __fmul_rn(g, s.scale);
  const float m1 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  const float v1 =
      __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.c2, __fmul_rn(g, g)));
  const float mh = __fdiv_rn(m1, s.bc1);
  const float vh = __fdiv_rn(v1, s.bc2);
  const float delta = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)),
                                __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
  m = m1;
  v = v1;
}

template <typename PT, typename GT, typename ST>
__device__ __forceinline__ void step_tile(const Leaves& L, const Tile& T,
                                          const Hyper& h, const Step& s) {
  PT* p = static_cast<PT*>(L.p[T.leaf]) + T.e0;
  const GT* g = static_cast<const GT*>(L.g[T.leaf]) + T.e0;
  ST* m = static_cast<ST*>(L.m[T.leaf]) + T.e0;
  ST* v = static_cast<ST*>(L.v[T.leaf]) + T.e0;
  int done = 0;
  if (L.code[T.leaf] & kAligned) {
    done = T.count / kVec * kVec;
    for (int i = threadIdx.x * kVec; i < done; i += kThreads * kVec) {
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load8(p + i, pf);
      load8(g + i, gf);
      load8(m + i, mf);
      load8(v + i, vf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) update(pf[j], gf[j], mf[j], vf[j], h, s);
      store8(p + i, pf);
      store8(m + i, mf);
      store8(v + i, vf);
    }
  }
  for (int i = done + threadIdx.x; i < T.count; i += kThreads) {
    float pf = repro::to_f(p[i]), mf = repro::to_f(m[i]),
          vf = repro::to_f(v[i]);
    update(pf, repro::to_f(g[i]), mf, vf, h, s);
    p[i] = repro::from_f<PT>(pf);
    m[i] = repro::from_f<ST>(mf);
    v[i] = repro::from_f<ST>(vf);
  }
}

template <typename PT, typename GT>
__device__ __forceinline__ void step_tile_s(const Leaves& L, const Tile& T,
                                            const Hyper& h, const Step& s,
                                            bool state_bf16) {
  if (state_bf16)
    step_tile<PT, GT, __nv_bfloat16>(L, T, h, s);
  else
    step_tile<PT, GT, float>(L, T, h, s);
}

// clamp's min and max, which keep a NaN (x != x)
__device__ __forceinline__ float nan_max(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float nan_min(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

__global__ void __launch_bounds__(kThreads)
adamw_step(const Leaves L, const double* __restrict__ partials,
           int npartials, float* __restrict__ grad_norm, const Hyper h) {
  __shared__ double red[kThreads / 32];
  double acc = 0.0;
  for (int i = threadIdx.x; i < npartials; i += kThreads) acc += partials[i];
  const float gnorm = (float)sqrt(block_sum(acc, red));
  if (blockIdx.x == 0 && threadIdx.x == 0 && grad_norm != nullptr)
    *grad_norm = gnorm;
  const float inv = __fdiv_rn(1.0f, nan_max(gnorm, h.floor));
  const Step s{nan_min(__fmul_rn(inv, h.clip), 1.0f), *h.lr, *h.bc1, *h.bc2};
  const int tiles = L.tile0[L.count];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile T = tile_at(L, t);
    const int code = L.code[T.leaf];
    const bool sb = code & kSBf16;
    switch (code & (kPBf16 | kGBf16)) {
      case 0: step_tile_s<float, float>(L, T, h, s, sb); break;
      case kPBf16: step_tile_s<__nv_bfloat16, float>(L, T, h, s, sb); break;
      case kGBf16: step_tile_s<float, __nv_bfloat16>(L, T, h, s, sb); break;
      default: step_tile_s<__nv_bfloat16, __nv_bfloat16>(L, T, h, s, sb);
    }
  }
}

// Leaves [first, first + count) of the host table as a kernel's table.
bool fill(Leaves& L, const uint64_t* ptrs, const long long* numel,
          const int* code, int total, int first, int count) {
  memset(&L, 0, sizeof(L));
  L.count = count;
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    const int k = first + i;
    L.p[i] = reinterpret_cast<void*>(ptrs[k]);
    L.g[i] = reinterpret_cast<const void*>(ptrs[total + k]);
    L.m[i] = reinterpret_cast<void*>(ptrs[2 * total + k]);
    L.v[i] = reinterpret_cast<void*>(ptrs[3 * total + k]);
    L.n[i] = numel[k];
    L.code[i] = code[k];
    L.tile0[i] = (int)tiles;
    if (numel[k] < 0) return false;
    tiles += (numel[k] + kTile - 1) / kTile;
    if (tiles > 0x7fffffffLL) return false;
  }
  L.tile0[count] = (int)tiles;
  return true;
}

}  // namespace

// One AdamW step of `count` leaves.  ptrs holds four rows of `count`
// device addresses (p, g, m, v), numel each leaf's elements, code its
// kernels/adamw.py::leaf_code.  The table is cut into launches of at most
// kMaxLeaves leaves: first an adamw_sumsq of each, writing `grid` f64
// partials at partials[chunk * grid], then an adamw_step of each, which
// folds all of them; the first writes the norm to grad_norm (f32).  lr,
// bc1, bc2: f32 device scalars.  Every launch has `grid` blocks.
extern "C" int repro_adamw(const uint64_t* ptrs, const long long* numel,
                           const int* code, int count, void* partials,
                           void* grad_norm, const void* lr, const void* bc1,
                           const void* bc2, float b1, float c1, float b2,
                           float c2, float eps, float wd, float clip,
                           float floor, int grid, void* stream) {
  if (count < 1 || grid < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto part = static_cast<double*>(partials);
  const int chunks = (count + kMaxLeaves - 1) / kMaxLeaves;
  Leaves L;  // ~24 KB; each launch copies it into its parameters
  for (int c = 0; c < chunks; ++c) {
    const int first = c * kMaxLeaves;
    const int n = count - first < kMaxLeaves ? count - first : kMaxLeaves;
    if (!fill(L, ptrs, numel, code, count, first, n))
      return cudaErrorInvalidValue;
    adamw_sumsq<<<grid, kThreads, 0, st>>>(L, part + (long long)c * grid);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const Hyper h{static_cast<const float*>(lr), static_cast<const float*>(bc1),
                static_cast<const float*>(bc2), b1, c1, b2, c2, eps, wd,
                clip, floor};
  for (int c = 0; c < chunks; ++c) {
    const int first = c * kMaxLeaves;
    const int n = count - first < kMaxLeaves ? count - first : kMaxLeaves;
    if (!fill(L, ptrs, numel, code, count, first, n))
      return cudaErrorInvalidValue;
    adamw_step<<<grid, kThreads, 0, st>>>(
        L, part, chunks * grid, c == 0 ? static_cast<float*>(grad_norm)
                                       : nullptr, h);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
