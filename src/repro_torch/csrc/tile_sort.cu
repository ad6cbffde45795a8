// Per-row ascending sort of float32 keys with an int32 payload, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/tile_sort.py::_bitonic_kernel (the Pallas
// bitonic sorter, the paper's GSU). Each key is packed with its lane as a
// 64-bit item (order-preserving key bits << 32 | lane); the row is padded
// to n = a power of two with items that sort last, and the bitonic network
// of bitonic.cuh sorts the items in registers, E consecutive items per
// thread. Because the lane breaks every tie, the result is the stable
// sort: equal keys keep their input order, -0 sorts with +0 and NaN last,
// as torch.sort(stable=True) and jnp.argsort(stable=True) order them.
//
// Layout (kernels/tile_sort.py::sort_layout picks it): rows of n <= 32E
// items take one warp each, eight rows to a CTA, and never wait at a CTA
// barrier; longer rows take n / E threads (E = 8, or 16 past n = 8192),
// and only the network's strides >= 32E go through shared memory.
//
// What bounds it: bytes. A row's K keys and K values are read once and
// written once; the (n/2) log2(n)(log2(n)+1)/2 compare-exchanges run in
// registers, warp shuffles and (for 3 of the 55 sweeps at n = 1024)
// shared memory. The design keeps device memory to those coalesced
// passes: the raw keys are read into shared memory and the values into
// registers at the start; at the end the sorted lanes gather both from
// shared memory (so the output keys keep their own bits, NaN payloads and
// -0 included) and the rows are stored coalesced.

#include <cuda_runtime.h>
#include <math.h>

#include "bitonic.cuh"

namespace {

// Shared-memory index of element i of a 32-bit array, one word of padding
// per 32 so that both a warp's consecutive elements and its strided
// elements t*E + j (E <= 16) fall in distinct banks.
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// 32-bit words of shared memory one row takes: the exchange buffer (n
// items; reused at the end for the sorted lanes and the values) and the
// raw keys, each rounded up to an even count so items stay 8-byte aligned.
__host__ __device__ __forceinline__ int row_words(int k, int n, int e) {
  int x = pad(n) + pad(k);
  if (n > 32 * e && 2 * n > x) x = 2 * n;
  return ((x + 1) & ~1) + ((pad(k) + 1) & ~1);
}

// kMaxThreads bounds the CTA (256 or 1024), and with it the registers a
// thread may take: rows of up to 256 threads keep every item and value in
// registers.
template <int E, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) tile_sort_kernel(
    const float* __restrict__ keys, const int* __restrict__ values,
    float* __restrict__ out_keys, int* __restrict__ out_values, int rows,
    int k, int n, int rows_per_cta) {
  extern __shared__ unsigned long long smem[];
  const int nt = n / E;                       // threads per row
  const int t = threadIdx.x % nt;
  const int row_i = blockIdx.x * rows_per_cta + threadIdx.x / nt;
  // Rows past the last only occur with one warp per row, which never
  // waits at a CTA barrier, so the whole warp may leave.
  if (row_i >= rows) return;
  const auto sync = [nt]() {
    if (nt > 32) __syncthreads(); else __syncwarp();
  };
  unsigned int* region = reinterpret_cast<unsigned int*>(smem) +
                         static_cast<size_t>(threadIdx.x / nt) *
                             row_words(k, n, E);
  unsigned long long* xchg = reinterpret_cast<unsigned long long*>(region);
  float* s_key = reinterpret_cast<float*>(region) +
                 (row_words(k, n, E) - ((pad(k) + 1) & ~1));
  const size_t row = static_cast<size_t>(row_i) * k;

  for (int s = t; s < k; s += nt) s_key[pad(s)] = keys[row + s];
  int v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int s = j * nt + t;
    v[j] = s < k ? values[row + s] : 0;
  }
  sync();

  // Padding positions (>= k) carry the largest key bits and lanes past
  // every real lane, so they sort after every real key, NaN included.
  unsigned long long x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int p = t * E + j;
    const unsigned int bits =
        p < k ? bitonic::order_bits(s_key[pad(p)]) : 0xFFFFFFFFu;
    x[j] = (static_cast<unsigned long long>(bits) << 32) |
           static_cast<unsigned int>(p);
  }
  bitonic::sort<E>(x, t, nt, xchg, sync);

  // The exchange buffer is free again (its last sweep ended at a barrier):
  // sorted lanes at [pad(p)], then the values in input order.
  int* s_lane = reinterpret_cast<int*>(region);
  int* s_val = s_lane + pad(n);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    s_lane[pad(t * E + j)] = static_cast<int>(x[j] & 0xFFFFFFFFull);
    const int s = j * nt + t;
    if (s < k) s_val[pad(s)] = v[j];
  }
  sync();
  for (int s = t; s < k; s += nt) {
    const int l = s_lane[pad(s)];
    out_keys[row + s] = s_key[pad(l)];
    out_values[row + s] = s_val[pad(l)];
  }
}

template <int E, int kMaxThreads>
int launch_bounded(const float* keys, const int* values, float* out_keys,
                   int* out_values, int rows, int k, int n, int rows_per_cta,
                   cudaStream_t stream) {
  const int threads = n / E * rows_per_cta;
  const size_t smem =
      static_cast<size_t>(rows_per_cta) * row_words(k, n, E) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel<E, kMaxThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0 && k > 0) {
    const int grid = (rows + rows_per_cta - 1) / rows_per_cta;
    tile_sort_kernel<E, kMaxThreads><<<grid, threads, smem, stream>>>(
        keys, values, out_keys, out_values, rows, k, n, rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int launch(const float* keys, const int* values, float* out_keys,
           int* out_values, int rows, int k, int n, int rows_per_cta,
           cudaStream_t stream) {
  if (n / E * rows_per_cta <= 256)
    return launch_bounded<E, 256>(keys, values, out_keys, out_values, rows,
                                  k, n, rows_per_cta, stream);
  return launch_bounded<E, 1024>(keys, values, out_keys, out_values, rows, k,
                                 n, rows_per_cta, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). keys (T, K) float32 and
// values (T, K) int32, contiguous; n (a power of two >= K), e (items per
// thread: 1, 2, 4, 8 or 16) and rows_per_cta as sort_layout gives them:
// n / e (32 to 1024) threads per row, and rows_per_cta > 1 only where
// n / e == 32.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another layout.
extern "C" int tile_sort(const float* keys, const int* values,
                         float* out_keys, int* out_values, int t, int k,
                         int n, int e, int rows_per_cta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = e > 0 && n >= k && n % e == 0 && n / e >= 32 &&
                  n / e <= 1024 && (n & (n - 1)) == 0 &&
                  (rows_per_cta == 1 || n / e == 32) &&
                  n / e * rows_per_cta <= 1024;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (e) {
    case 1: return launch<1>(keys, values, out_keys, out_values, t, k, n,
                             rows_per_cta, s);
    case 2: return launch<2>(keys, values, out_keys, out_values, t, k, n,
                             rows_per_cta, s);
    case 4: return launch<4>(keys, values, out_keys, out_values, t, k, n,
                             rows_per_cta, s);
    case 8: return launch<8>(keys, values, out_keys, out_values, t, k, n,
                             rows_per_cta, s);
    case 16: return launch<16>(keys, values, out_keys, out_values, t, k, n,
                               rows_per_cta, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
