// Fused per-slot depth sort + alpha blend for Hopper (sm_90a).
//
// Replaces repro/kernels/raster_plan.py::_fused_kernel (the Pallas
// kernel behind raster_plan_fused). One CTA per plan slot, 256 threads,
// one thread per pixel of the slot's 16x16 tile:
//
//   1. the slot's lanes [0, count) are keyed by depth, padding by +inf,
//      and bitonic-sorted in shared memory by (depth, original lane), the
//      original lane index riding the compare-exchanges as the payload;
//      only the first pow2(count) lanes take part (the padding tail is
//      already in order);
//   2. the blend records are gathered into shared memory in sorted order,
//      packed as blend.cuh lays them out (with the sort's keys and lanes,
//      12 x 4 B x K_pad in all: 48 KiB at K_pad = 1024);
//   3. front-to-back blend chunk by chunk with the reference semantics
//      (blend.cuh, shared with raster_tile.cu: alpha = min(o e^power,
//      0.99), alpha < 1/255 -> 0, sticky done at T < 1e-4); the CTA stops
//      once every pixel is done (__syncthreads_or), as chunk_cond does in
//      the Pallas kernel;
//   4. each lane's contribution (sum over the 256 pixels of alpha*T) is
//      reduced in a fixed order (blend.cuh: the warp's xor-butterfly tree,
//      then the eight warp partials in order), so runs repeat bit for
//      bit, and written straight to its INPUT lane through the payload.
//
// What bounds it: the blend's arithmetic (about 16 flops and one expf per
// pixel and lane reached before the pixel is done, 17 more where the
// lane blends); bytes are small (each real lane's 40 B record is read
// once). The design keeps every lane in shared memory from sort to blend,
// reads it there as three broadcast vector loads (all threads of a warp
// read the same address), and skips inactive or empty slots before the
// sort. The sort (55 barrier-separated sweeps at K_pad = 1024) is
// unchanged here; bitonic.cuh's register network is its replacement.
//
// Built with -fmad=false so that the per-pixel arithmetic rounds as the
// plain PyTorch version's separate operations do.

#include <cuda_runtime.h>
#include <math.h>

#include "blend.cuh"

namespace {

using blend::kThreads;
using blend::kWarps;
// CTAs a SM must fit: caps a thread at 64 registers (a few spill), so
// that the 32 lane weights blend.cuh keeps in registers do not cost the
// occupancy the barrier-bound sort needs.
constexpr int kMinCtas = 4;

__device__ __forceinline__ bool after(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

__global__ void __launch_bounds__(kThreads, kMinCtas) raster_plan_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ rgb, const float* __restrict__ opacity,
    const float* __restrict__ depth, const float* __restrict__ origins,
    const int* __restrict__ counts, const int* __restrict__ slot_active,
    float* __restrict__ out_rgb, float* __restrict__ out_trans,
    float* __restrict__ out_depth, float* __restrict__ out_tdepth,
    int* __restrict__ out_processed, float* __restrict__ out_contrib,
    int k, int k_pad, int chunk) {
  extern __shared__ float smem[];
  const blend::Lanes lanes = blend::lanes_at(smem, k_pad, smem + 12 * k_pad);
  float* s_key = smem + 10 * k_pad;         // depth, sorted
  int* s_idx = reinterpret_cast<int*>(smem + 11 * k_pad);

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[slot], 0), k);
  const bool active = slot_active[slot] != 0 && count > 0;
  const size_t row = static_cast<size_t>(slot) * k;

  for (int l = tid; l < k_pad; l += kThreads) {
    s_key[l] = (active && l < count) ? depth[row + l] : INFINITY;
    s_idx[l] = l;
  }
  __syncthreads();

  // ---- bitonic sort of (depth, lane) over the first pow2(count) lanes ----
  if (active) {
    int n_sort = 1;
    while (n_sort < count) n_sort <<= 1;
    for (int span = 2; span <= n_sort; span <<= 1) {
      for (int stride = span >> 1; stride > 0; stride >>= 1) {
        for (int p = tid; p < n_sort / 2; p += kThreads) {
          const int lo = (p / stride) * 2 * stride + (p % stride);
          const int hi = lo + stride;
          const float ka = s_key[lo], kb = s_key[hi];
          const int ia = s_idx[lo], ib = s_idx[hi];
          const bool up = (lo & span) == 0;
          if (up ? after(ka, ia, kb, ib) : after(kb, ib, ka, ia)) {
            s_key[lo] = kb;
            s_key[hi] = ka;
            s_idx[lo] = ib;
            s_idx[hi] = ia;
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- gather the blend record in sorted order; padding lanes read 0 ----
  for (int s = tid; s < k_pad; s += kThreads) {
    if (active && s < count) {
      const size_t g = row + s_idx[s];
      blend::store_lane(lanes, s, mean2d[2 * g], mean2d[2 * g + 1],
                        conic[3 * g], conic[3 * g + 1], conic[3 * g + 2],
                        opacity[g], rgb[3 * g], rgb[3 * g + 1],
                        rgb[3 * g + 2], s_key[s]);
    } else {  // padding depth 0: 0 * inf is NaN
      blend::store_lane(lanes, s, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                        0.0f, 0.0f, 0.0f);
    }
  }

  // ---- chunked front-to-back blend, one thread per pixel ----
  const int used = active ? min((count + chunk - 1) / chunk, k_pad / chunk) : 0;
  const int n_run =
      blend::render_tile(lanes, origins, slot, used, count, chunk, out_rgb,
                         out_trans, out_depth, out_tdepth, out_processed);
  // Every input lane gets its contribution (0 where no chunk ran).
  const int ran = n_run * chunk;
  for (int s = tid; s < k_pad; s += kThreads) {
    const int l = s_idx[s];
    if (l < k) out_contrib[row + l] = s < ran ? lanes.c[s].y : 0.0f;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Inputs are contiguous float32
// (R, K, ...) bins plus origins (R, 2), counts and slot_active (R,) int32;
// k_pad is the power of two >= max(K, chunk). Returns cudaGetLastError().
extern "C" int raster_plan_fused(
    const float* mean2d, const float* conic, const float* rgb,
    const float* opacity, const float* depth, const float* origins,
    const int* counts, const int* slot_active, float* out_rgb,
    float* out_trans, float* out_depth, float* out_tdepth,
    int* out_processed, float* out_contrib, int r, int k, int k_pad,
    int chunk, void* stream) {
  const size_t smem = (12 * static_cast<size_t>(k_pad) +
                       static_cast<size_t>(kWarps) * chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      raster_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    raster_plan_kernel<<<r, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        mean2d, conic, rgb, opacity, depth, origins, counts, slot_active,
        out_rgb, out_trans, out_depth, out_tdepth, out_processed,
        out_contrib, k, k_pad, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
