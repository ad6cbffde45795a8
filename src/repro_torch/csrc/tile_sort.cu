// Per-row ascending sort of float32 keys with an int32 payload, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/tile_sort.py::_bitonic_kernel (the Pallas
// bitonic sorter, the paper's GSU). One CTA per row: the row's keys are
// packed with their lane as 64-bit items (order-preserving key bits << 32
// | lane) in shared memory, the row is padded to a power of two with
// items that sort last, and a bitonic network of log2(K)(log2(K)+1)/2
// compare-exchange sweeps sorts the items. Because the lane breaks every
// tie, the result is the stable sort: equal keys keep their input order,
// -0 sorts with +0 and NaN last, as torch.sort(stable=True) and
// jnp.argsort(stable=True) order them. The sorted lanes then gather the
// keys and payload values straight from global memory.
//
// What bounds it: bytes. A row's K keys and K values are read, and K of
// each written; the network's (K/2) log2(K)(log2(K)+1)/2 compares run in
// shared memory (8 B x K_pad: 8 KiB at K = 1024), never in device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

// float32 -> uint32 whose unsigned order is torch.sort's order of floats.
__device__ __forceinline__ unsigned int order_bits(float key) {
  if (isnan(key)) return 0xFFFFFFFFu;
  if (key == 0.0f) return 0x80000000u;  // -0 ties with +0
  const unsigned int b = __float_as_uint(key);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads) tile_sort_kernel(
    const float* __restrict__ keys, const int* __restrict__ values,
    float* __restrict__ out_keys, int* __restrict__ out_values, int k,
    int k_pad) {
  extern __shared__ unsigned long long s_item[];
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * k;

  // Padding lanes (>= k) carry the largest key bits and lanes past every
  // real lane, so they sort after every real key, NaN included.
  for (int l = tid; l < k_pad; l += kThreads) {
    const unsigned int bits = l < k ? order_bits(keys[row + l]) : 0xFFFFFFFFu;
    s_item[l] = (static_cast<unsigned long long>(bits) << 32) |
                static_cast<unsigned int>(l);
  }
  __syncthreads();

  for (int span = 2; span <= k_pad; span <<= 1) {
    for (int stride = span >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < k_pad / 2; p += kThreads) {
        const int lo = (p / stride) * 2 * stride + (p % stride);
        const int hi = lo + stride;
        const unsigned long long a = s_item[lo], b = s_item[hi];
        const bool up = (lo & span) == 0;
        if (up ? a > b : a < b) {
          s_item[lo] = b;
          s_item[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int s = tid; s < k; s += kThreads) {
    const size_t g = row + static_cast<unsigned int>(s_item[s] & 0xFFFFFFFFull);
    out_keys[row + s] = keys[g];
    out_values[row + s] = values[g];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). keys (T, K) float32 and
// values (T, K) int32, contiguous; k_pad is the power of two >= K.
// Returns cudaGetLastError().
extern "C" int tile_sort(const float* keys, const int* values,
                         float* out_keys, int* out_values, int t, int k,
                         int k_pad, void* stream) {
  const size_t smem = static_cast<size_t>(k_pad) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t > 0 && k > 0) {
    tile_sort_kernel<<<t, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        keys, values, out_keys, out_values, k, k_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
