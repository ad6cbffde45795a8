// Raster-only alpha blend over depth-sorted bins for Hopper (sm_90a).
//
// Replaces repro/kernels/raster_tile.py::_raster_kernel (the Pallas
// kernel behind the reference's impl="pallas"). Binning already put each
// tile's lanes in (depth, id) order, so there is no sort: one CTA per
// tile (or plan slot), 256 threads, one thread per pixel of the 16x16
// tile:
//
//   1. the lanes the blend can reach (the first ceil(count / chunk)
//      chunks) are read once into shared memory as packed records (float4,
//      float4, float2: 10 x 4 B x K, 40 KiB at K = 1024); lanes past count
//      read as 0, as the fused kernel's padding does;
//   2. the chunked front-to-back blend of blend.cuh, the same code the
//      fused kernel runs, so the two impls blend in one order and agree
//      bit for bit on (depth, id)-sorted bins;
//   3. each lane's contribution, reduced in a fixed order inside the
//      blend, is written to its own lane (no unscrambling: the lanes are
//      already in input order).
//
// What bounds it: the blend's arithmetic, as for the fused kernel (about
// 16 flops and one expf per pixel and lane reached before the pixel is
// done, 17 more where the lane blends); each real lane's 40 B record is
// read once. On the card the loop is held back by the instructions it
// issues around that arithmetic more than by the arithmetic itself, so
// blend.cuh cuts them: a lane's record reaches the warp as three broadcast
// vector loads (not ten scalar ones), and the lane contributions are
// reduced 32 lanes at a time by a transposed butterfly (about one shuffle
// a lane, not a vote and five). Empty tiles skip the blend.
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
// that the 32 lane weights blend.cuh keeps in registers do not cost
// occupancy.
constexpr int kMinCtas = 4;

__global__ void __launch_bounds__(kThreads, kMinCtas) raster_tile_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ rgb, const float* __restrict__ opacity,
    const float* __restrict__ depth, const float* __restrict__ origins,
    const int* __restrict__ counts, float* __restrict__ out_rgb,
    float* __restrict__ out_trans, float* __restrict__ out_depth,
    float* __restrict__ out_tdepth, int* __restrict__ out_processed,
    float* __restrict__ out_contrib, int k, int chunk) {
  extern __shared__ float smem[];
  const blend::Lanes lanes = blend::lanes_at(smem, k, smem + 10 * k);

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[slot], 0), k);
  const size_t row = static_cast<size_t>(slot) * k;
  const int used = (count + chunk - 1) / chunk;  // <= k / chunk

  for (int l = tid; l < used * chunk; l += kThreads) {
    if (l < count) {
      const size_t g = row + l;
      blend::store_lane(lanes, l, mean2d[2 * g], mean2d[2 * g + 1],
                        conic[3 * g], conic[3 * g + 1], conic[3 * g + 2],
                        opacity[g], rgb[3 * g], rgb[3 * g + 1],
                        rgb[3 * g + 2], depth[g]);
    } else {
      blend::store_lane(lanes, l, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                        0.0f, 0.0f, 0.0f);
    }
  }

  const int n_run =
      blend::render_tile(lanes, origins, slot, used, count, chunk, out_rgb,
                         out_trans, out_depth, out_tdepth, out_processed);
  // Every lane gets its contribution (0 where no chunk ran).
  const int ran = n_run * chunk;
  for (int l = tid; l < k; l += kThreads)
    out_contrib[row + l] = l < ran ? lanes.c[l].y : 0.0f;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Inputs are contiguous float32
// (R, K, ...) bins, depth-sorted within each row, plus origins (R, 2) and
// counts (R,) int32; K is a multiple of chunk and chunk <= 256. Shared
// memory: the packed records (10 floats a lane) and the warp partials.
// Returns cudaGetLastError().
extern "C" int raster_tile(
    const float* mean2d, const float* conic, const float* rgb,
    const float* opacity, const float* depth, const float* origins,
    const int* counts, float* out_rgb, float* out_trans, float* out_depth,
    float* out_tdepth, int* out_processed, float* out_contrib, int r, int k,
    int chunk, void* stream) {
  const size_t smem = (10 * static_cast<size_t>(k) +
                       static_cast<size_t>(kWarps) * chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      raster_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    raster_tile_kernel<<<r, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        mean2d, conic, rgb, opacity, depth, origins, counts, out_rgb,
        out_trans, out_depth, out_tdepth, out_processed, out_contrib, k,
        chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
