// AdamW over every leaf of a model in three launches, for Hopper (sm_90a):
// the global gradient norm (two launches) and the update (one).
//
// Replaces no TPU kernel: the reference's optimizer
// (repro/train/optimizer.py::adamw_update) is jnp, which XLA fuses. The
// port's plain version (train/optimizer.py::adamw_update_eager) runs it
// leaf by leaf in eager PyTorch, 24 float32 passes a leaf (about 200 bytes
// an element); this library computes the same numbers in one pass over the
// state, so a train step's optimizer moves what the algorithm needs.
//
// What bounds it: bytes. An element of a bf16 leaf needs 24: its gradient
// read for the norm (2), then gradient, parameter and both float32 moments
// read (12) and parameter and moments written (10); of a float32 leaf 32
// (4, 16 and 12). Against about 8
// floating-point operations; the card does ~295 operations a byte before
// its tensor cores, and ~20 of float32, are the limit. So the design
// streams: 16-byte loads and stores, groups of 8 elements a thread (the
// norm's loads four groups ahead), every CTA on one chunk of one leaf, and
// nothing kept between the launches but one double a chunk. Measured on
// an H100 at minicpm3-4b's 871 leaves: the update at 2.97 TB/s, all three
// launches at 0.88 of the bound (chip_smoke.py phase 7c).
//
// The leaf table (the wrapper's, kernels/adamw.py): one row of 8 int64 a
// leaf, in the dict's order: the addresses of p, m and v, the element
// count n, the index of the leaf's first chunk over all leaves, `head`
// (the elements before p, g, m and v are all 16-byte aligned, 0..7),
// whether p and g are bfloat16 (else float32), and g's address. The
// wrapper builds and uploads it anew each call. A leaf's chunks: [0, head)
// where head > 0, then kChunk elements at a time from head, the last one
// ragged. A CTA finds its leaf by binary search over the first-chunk
// indices. Inside a chunk thread t takes groups t, t + kThreads, ... of 8
// consecutive elements; a group is loaded with 16-byte accesses where the
// chunk's start is aligned for every tensor it touches, else element by
// element (the head chunk, a ragged tail, a leaf whose pointers share no
// alignment). Loads never change the arithmetic.
//
// The norm, in a fixed order (no atomics: a repeat is bit-equal):
//   a group's squares in float32 (a bf16 value's square is exact), summed
//   pairwise ((q0+q1)+(q2+q3))+((q4+q5)+(q6+q7)) in float32;
//   a thread's groups added in order into a double;
//   a CTA's 256 doubles by a halving tree (a[t] += a[t + s], s = 128..1)
//   into the chunk's partial;
//   norm_finish (one CTA of 32 warps): warp w takes leaves w, w + 32, ...,
//   lane l adds the leaf's partials l, l + 32, ... in order, then a halving
//   tree over the lanes gives the leaf's sum; thread t adds the leaf sums
//   t, t + 1024, ... in order, and a halving tree over the 1024 gives the
//   total. norm = float(sqrt(total)) in double, so the norm is within a
//   float32 rounding of the float64 norm; the plain model of this order is
//   kernels/adamw.py::global_norm_plain.
//   scale = min(reciprocal(norm + 1e-9) * clip, 1) in float32, NaN kept,
//   as the eager path's clamp_max(clip / (norm + 1e-9), 1.0) rounds it.
//   Norm and scale stay on the device; the host reads nothing.
//
// The update, each element once, in the eager path's order of operations
// and with its rounding (the build passes -fmad=false, and every step is
// an _rn intrinsic, so nothing is contracted):
//   g' = g * scale
//   m  = m * b1 + c1 * g'            (c1 = float(1 - b1))
//   v  = v * b2 + (c2 * g') * g'     (c2 = float(1 - b2))
//   d  = (m * ib1) / (sqrt(v * ib2) + eps) + wd * p
//   p  = round(p - lr * d)           to p's dtype, nearest even
// where ib1 = 1 / float(1 - b1^step) and ib2 likewise are float32
// reciprocals, as torch's CUDA division by a host scalar multiplies by
// one; the wrapper turns every Python scalar into float32 as torch does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // a CTA of the norm and the update
constexpr int kFinishThreads = 1024;   // the one CTA of norm_finish
constexpr int kWarp = 32;
constexpr int kGroup = 8;              // elements a thread takes at a time
constexpr long long kChunk = 32768;    // elements a CTA; a multiple of 8

struct Leaf {                // a row of the wrapper's table
  long long p, m, v;         // addresses
  long long n;               // elements
  long long chunk0;          // its first chunk's index over all leaves
  long long head;            // elements before the aligned body, 0..7
  long long bf16;            // 1: p and g bfloat16; 0: float32
  long long g;               // the gradient's address
};

struct Scalars {             // float32 values of the step's settings
  float b1, c1, b2, c2, ib1, ib2, eps, wd, lr;
};

__device__ __forceinline__ int find_leaf(const Leaf* leaves, int n_leaves,
                                         long long c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// [start, end) of the leaf's chunk k.
__device__ __forceinline__ void chunk_span(const Leaf& L, long long k,
                                           long long* start, long long* end) {
  long long s;
  if (L.head > 0) s = k == 0 ? 0 : L.head + (k - 1) * kChunk;
  else s = k * kChunk;
  const long long e = (L.head > 0 && k == 0) ? L.head : s + kChunk;
  *start = s;
  *end = e < L.n ? e : L.n;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements i .. i + cnt - 1 of x as float32 into out[0..7] (zeros past
// cnt); `vec`: cnt == 8 and x + i 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* x, long long i,
                                      int cnt, bool vec, float* out) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(x + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      out[j] = j < cnt ? __bfloat162float(x[i + j]) : 0.0f;
  }
}

__device__ __forceinline__ void load8(const float* x, long long i, int cnt,
                                      bool vec, float* out) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(x + i);
    const float4 b = *reinterpret_cast<const float4*>(x + i + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) out[j] = j < cnt ? x[i + j] : 0.0f;
  }
}

// out[0..cnt) into x + i, each value rounded to x's type (nearest even).
__device__ __forceinline__ void store8(__nv_bfloat16* x, long long i, int cnt,
                                       bool vec, const float* in) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(in[2 * j], in[2 * j + 1]);
    *reinterpret_cast<uint4*>(x + i) = u;
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (j < cnt) x[i + j] = __float2bfloat16_rn(in[j]);
  }
}

__device__ __forceinline__ void store8(float* x, long long i, int cnt,
                                       bool vec, const float* in) {
  if (vec) {
    *reinterpret_cast<float4*>(x + i) =
        make_float4(in[0], in[1], in[2], in[3]);
    *reinterpret_cast<float4*>(x + i + 4) =
        make_float4(in[4], in[5], in[6], in[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (j < cnt) x[i + j] = in[j];
  }
}

// a[0] = the halving tree of a[0..n) (n a power of two), every thread of
// the CTA calling; a in shared memory.
__device__ __forceinline__ void tree(double* a, int n) {
  for (int s = n >> 1; s > 0; s >>= 1) {
    if (static_cast<int>(threadIdx.x) < s) a[threadIdx.x] += a[threadIdx.x + s];
    __syncthreads();
  }
}

// A group's sum of squares: float32 squares summed pairwise.
__device__ __forceinline__ float sumsq8(const float* x) {
  float q[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) q[j] = __fmul_rn(x[j], x[j]);
  return __fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), __fadd_rn(q[2], q[3])),
                   __fadd_rn(__fadd_rn(q[4], q[5]), __fadd_rn(q[6], q[7])));
}

// The thread's groups of [s, e), added in order into a double. Loads are
// issued kUnroll groups at a time (the adds keep the groups' order), so a
// thread has 64 bytes in flight, not 16.
template <typename T>
__device__ __forceinline__ double chunk_sumsq(const T* g, long long s,
                                              long long e) {
  constexpr int kUnroll = 4;
  constexpr long long kStride = static_cast<long long>(kThreads) * kGroup;
  const bool vec = aligned16(g + s);
  double acc = 0.0;
  long long i = s + static_cast<long long>(threadIdx.x) * kGroup;
  for (; i + (kUnroll - 1) * kStride < e; i += kUnroll * kStride) {
    float x[kUnroll][kGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = i + u * kStride;
      const int cnt = static_cast<int>(e - at < kGroup ? e - at : kGroup);
      load8(g, at, cnt, vec && cnt == kGroup, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc = __dadd_rn(acc, static_cast<double>(sumsq8(x[u])));
  }
  for (; i < e; i += kStride) {
    const int cnt = static_cast<int>(e - i < kGroup ? e - i : kGroup);
    float x[kGroup];
    load8(g, i, cnt, vec && cnt == kGroup, x);
    acc = __dadd_rn(acc, static_cast<double>(sumsq8(x)));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
norm_chunks(const Leaf* __restrict__ leaves, int n_leaves,
            double* __restrict__ partials) {
  __shared__ double red[kThreads];
  const long long c = blockIdx.x;
  const int l = find_leaf(leaves, n_leaves, c);
  const Leaf L = leaves[l];
  long long s, e;
  chunk_span(L, c - L.chunk0, &s, &e);
  red[threadIdx.x] =
      L.bf16 ? chunk_sumsq(reinterpret_cast<const __nv_bfloat16*>(L.g), s, e)
             : chunk_sumsq(reinterpret_cast<const float*>(L.g), s, e);
  __syncthreads();
  tree(red, kThreads);
  if (threadIdx.x == 0) partials[c] = red[0];
}

__global__ void __launch_bounds__(kFinishThreads)
norm_finish(const Leaf* __restrict__ leaves, int n_leaves, long long n_chunks,
            const double* __restrict__ partials, double* __restrict__ sums,
            float* __restrict__ out, float clip, float tiny) {
  __shared__ double red[kFinishThreads];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int l = warp; l < n_leaves; l += kFinishThreads / kWarp) {
    const long long c0 = leaves[l].chunk0;
    const long long c1 = l + 1 < n_leaves ? leaves[l + 1].chunk0 : n_chunks;
    double a = 0.0;
    for (long long c = c0 + lane; c < c1; c += kWarp)
      a = __dadd_rn(a, partials[c]);
    for (int s = kWarp / 2; s > 0; s >>= 1)
      a = __dadd_rn(a, __shfl_down_sync(0xffffffffu, a, s));
    if (lane == 0) sums[l] = a;
  }
  __syncthreads();   // the leaf sums, written to global memory, are seen
  double a = 0.0;
  for (int l = threadIdx.x; l < n_leaves; l += kFinishThreads)
    a = __dadd_rn(a, sums[l]);
  red[threadIdx.x] = a;
  __syncthreads();
  tree(red, kFinishThreads);
  if (threadIdx.x == 0) {
    const float norm = __double2float_rn(__dsqrt_rn(red[0]));
    const float x = __fmul_rn(__frcp_rn(__fadd_rn(norm, tiny)), clip);
    out[0] = norm;
    out[1] = isnan(x) ? x : fminf(x, 1.0f);
  }
}

template <typename T>
__device__ __forceinline__ void update_chunk(const Leaf& L, const T* g,
                                             long long s, long long e,
                                             float scale, const Scalars& k) {
  T* p = reinterpret_cast<T*>(L.p);
  float* m = reinterpret_cast<float*>(L.m);
  float* v = reinterpret_cast<float*>(L.v);
  const bool vec = aligned16(p + s) && aligned16(g + s) && aligned16(m + s)
                   && aligned16(v + s);
  for (long long i = s + static_cast<long long>(threadIdx.x) * kGroup; i < e;
       i += static_cast<long long>(kThreads) * kGroup) {
    const int cnt = static_cast<int>(e - i < kGroup ? e - i : kGroup);
    const bool vg = vec && cnt == kGroup;
    float pf[kGroup], gf[kGroup], mf[kGroup], vf[kGroup];
    load8(g, i, cnt, vg, gf);
    load8(p, i, cnt, vg, pf);
    load8(m, i, cnt, vg, mf);
    load8(v, i, cnt, vg, vf);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float gs = __fmul_rn(gf[j], scale);
      mf[j] = __fadd_rn(__fmul_rn(mf[j], k.b1), __fmul_rn(k.c1, gs));
      vf[j] = __fadd_rn(__fmul_rn(vf[j], k.b2),
                        __fmul_rn(__fmul_rn(k.c2, gs), gs));
      const float mh = __fmul_rn(mf[j], k.ib1);
      const float vh = __fmul_rn(vf[j], k.ib2);
      const float d = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), k.eps)),
                                __fmul_rn(k.wd, pf[j]));
      pf[j] = __fsub_rn(pf[j], __fmul_rn(k.lr, d));
    }
    store8(p, i, cnt, vg, pf);
    store8(m, i, cnt, vg, mf);
    store8(v, i, cnt, vg, vf);
  }
}

__global__ void __launch_bounds__(kThreads)
update_chunks(const Leaf* __restrict__ leaves, int n_leaves,
              const float* __restrict__ norm_scale, Scalars k) {
  const long long c = blockIdx.x;
  const int l = find_leaf(leaves, n_leaves, c);
  const Leaf L = leaves[l];
  long long s, e;
  chunk_span(L, c - L.chunk0, &s, &e);
  const float scale = norm_scale[1];
  if (L.bf16)
    update_chunk(L, reinterpret_cast<const __nv_bfloat16*>(L.g), s, e, scale,
                 k);
  else
    update_chunk(L, reinterpret_cast<const float*>(L.g), s, e, scale, k);
}

}  // namespace

extern "C" {

long long adamw_chunk_elements() { return kChunk; }

// The norm: two launches on `stream`; returns the CUDA error code (0 on
// success). leaves (n_leaves, 8) int64, partials (n_chunks,) and sums
// (n_leaves,) double scratch, out (2,) float32: the norm and the clip
// scale.
int adamw_norm(const void* leaves, int n_leaves, long long n_chunks,
               double* partials, double* sums, float* out, float clip,
               float tiny, cudaStream_t stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL) return -1;
  const Leaf* table = static_cast<const Leaf*>(leaves);
  norm_chunks<<<static_cast<unsigned>(n_chunks), kThreads, 0, stream>>>(
      table, n_leaves, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_finish<<<1, kFinishThreads, 0, stream>>>(table, n_leaves, n_chunks,
                                                partials, sums, out, clip,
                                                tiny);
  return static_cast<int>(cudaGetLastError());
}

// The update: one launch on `stream`, in place on every leaf's p, m and
// v, reading the scale at norm_scale[1]; returns the CUDA error code.
int adamw_update(const void* leaves, int n_leaves, long long n_chunks,
                 const float* norm_scale, float b1, float c1, float b2,
                 float c2, float ib1, float ib2, float eps, float wd, float lr,
                 cudaStream_t stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL) return -1;
  const Scalars k{b1, c1, b2, c2, ib1, ib2, eps, wd, lr};
  update_chunks<<<static_cast<unsigned>(n_chunks), kThreads, 0, stream>>>(
      static_cast<const Leaf*>(leaves), n_leaves, norm_scale, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
