// A bitonic sorting network over items held in registers, for Hopper.
//
// A row of n items (n a power of two) is spread over nt = n / E threads,
// thread t holding the E consecutive items at positions t*E .. t*E+E-1.
// The network's log2(n)(log2(n)+1)/2 sweeps of compare-exchanges between
// positions p and p ^ stride (ascending where p & span is 0) run at one of
// three levels, chosen by the stride alone:
//
//   register  stride <  E      both items are the thread's own: no
//                              synchronisation at all;
//   shuffle   E <= stride < 32E  the partner item sits at the same slot of
//                              thread t ^ (stride / E), in the same warp:
//                              one __shfl_xor_sync per 32-bit word;
//   shared    stride >= 32E    the partner thread is in another warp: the
//                              items go through shared memory, a barrier
//                              on each side.
//
// So at n = 1024 and E = 8 only 3 of the 55 sweeps wait at a barrier.
// The item type needs operator< and a shuffle (shfl_xor below), and the
// items of a row must be distinct: a compare-exchange then takes the
// partner's item exactly where the order asks for a swap. Items that
// carry their lane, as tile_sort.cu's 64-bit (key bits, lane) do, are
// distinct, and sort stably by key.
//
// tile_sort.cu and raster_plan.cu run it on such items, built with
// order_bits below; kernels/tile_sort.py::network_schedule and
// kernels/raster_plan.py::network_schedule list the sweeps and levels.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bitonic {

// float32 -> uint32 whose unsigned order is torch.sort's order of floats:
// -0 ties with +0, every NaN sorts last.
__device__ __forceinline__ unsigned int order_bits(float key) {
  if (isnan(key)) return 0xFFFFFFFFu;
  if (key == 0.0f) return 0x80000000u;  // -0 ties with +0
  const unsigned int b = __float_as_uint(key);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned int shfl_xor(unsigned int v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}

__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long v,
                                                       int m) {
  const unsigned int lo = __shfl_xor_sync(0xffffffffu,
                                          static_cast<unsigned int>(v), m);
  const unsigned int hi = __shfl_xor_sync(
      0xffffffffu, static_cast<unsigned int>(v >> 32), m);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Sweeps of one merge step with strides top, top/2, ..., 1, all below E:
// compare-exchanges between the thread's own items.
template <int E, typename T>
__device__ __forceinline__ void register_sweeps(T (&x)[E], int t, int span,
                                                int top) {
#pragma unroll
  for (int s = E / 2; s > 0; s >>= 1) {
    if (s > top) continue;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j & s) continue;
      const T a = x[j], b = x[j | s];
      const bool swap = (b < a) == (((t * E + j) & span) == 0);
      x[j] = swap ? b : a;
      x[j | s] = swap ? a : b;
    }
  }
}

// One sweep with E <= stride < 32E: the partner is lane ^ (stride / E).
template <int E, typename T>
__device__ __forceinline__ void shuffle_sweep(T (&x)[E], int t, int span,
                                              int stride) {
  const int m = stride / E;
  const bool keep_min = (((t * E) & span) == 0) == ((t & m) == 0);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const T y = shfl_xor(x[j], m);
    if ((y < x[j]) == keep_min) x[j] = y;
  }
}

// One sweep with stride >= 32E through ``xchg`` (n items, item j of thread
// t at j * nt + t, so a warp's accesses are contiguous). ``sync`` is the
// row's barrier.
template <int E, typename T, typename Sync>
__device__ __forceinline__ void shared_sweep(T (&x)[E], int t, int nt,
                                             int span, int stride, T* xchg,
                                             Sync sync) {
  const int m = stride / E;
  const bool keep_min = (((t * E) & span) == 0) == ((t & m) == 0);
#pragma unroll
  for (int j = 0; j < E; ++j) xchg[j * nt + t] = x[j];
  sync();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const T y = xchg[j * nt + (t ^ m)];
    if ((y < x[j]) == keep_min) x[j] = y;
  }
  sync();
}

// Sort the row's n = nt * E items ascending; thread t of the row holds
// x = items t*E .. t*E+E-1 and gets back the same positions. ``xchg``
// (n items of shared memory) is touched only when n > 32E; then every
// thread of the row must call ``sort``.
template <int E, typename T, typename Sync>
__device__ __forceinline__ void sort(T (&x)[E], int t, int nt, T* xchg,
                                     Sync sync) {
  const int n = nt * E;
  for (int span = 2; span <= n; span <<= 1) {
    int stride = span >> 1;
    for (; stride >= 32 * E; stride >>= 1)
      shared_sweep<E>(x, t, nt, span, stride, xchg, sync);
    for (; stride >= E; stride >>= 1) shuffle_sweep<E>(x, t, span, stride);
    register_sweeps<E>(x, t, span, stride);
  }
}

}  // namespace bitonic
