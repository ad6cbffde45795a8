// Fused per-slot depth sort + alpha blend for Hopper (sm_90a).
//
// Replaces repro/kernels/raster_plan.py::_fused_kernel (the Pallas
// kernel behind raster_plan_fused). One CTA per plan slot, 256 threads,
// one thread per pixel of the slot's 16x16 tile:
//
//   1. sort: each of the slot's first n = max(pow2(count), 32 E) positions
//      becomes a 64-bit item (bitonic::order_bits(depth) << 32 | lane);
//      positions past count carry the largest bits and lanes past every
//      real lane, so they sort last. The items are sorted in registers by
//      bitonic.cuh's network, E consecutive items a thread on n / E
//      threads: rows of up to 32 E items stay within warp 0, longer ones
//      meet at a named barrier of their n / E threads. The lane breaks
//      every tie, so the order is (depth, lane), -0 tied with +0, as the
//      plain version's stable sort orders it. (order_bits puts NaN last
//      where a float comparison would leave it unordered; real lanes
//      never carry one: binning keeps only Gaussians with z > near.)
//      Each item then writes its sorted position into rank[lane];
//   2. records: each real lane's 40 B record is read in input order
//      (a warp reads 32 consecutive lanes of each field) and stored at
//      its sorted position, packed as blend.cuh lays them out; positions
//      past count up to the last chunk the blend can reach are zeroed;
//   3. front-to-back blend chunk by chunk with the reference semantics
//      (blend.cuh, shared with raster_tile.cu: alpha = min(o e^power,
//      0.99), alpha < 1/255 -> 0, sticky done at T < 1e-4; the CTA stops
//      once every pixel is done, as chunk_cond does in the Pallas
//      kernel); each lane's contribution is reduced there in a fixed
//      order, so runs repeat bit for bit;
//   4. contributions: thread l stores input lane l's contribution, read
//      from shared memory at rank[l], so the row is stored coalesced.
//
// What bounds it: the blend's arithmetic (about 16 flops and one expf per
// pixel and lane reached before the pixel is done, 17 more where the lane
// blends); bytes are small (each real lane's 40 B record is read once).
// The blend is the tile raster kernel's, so what this kernel adds to it
// is the sort and the scatter of the records. A sort of 1,024 lanes in
// shared memory with a barrier after each of its 55 sweeps took 61 % of
// the CTAs' cycles (PERF.md). In registers, with E = 4 on 256 threads
// (6 named barriers, strides >= 128), it took 42 %: its 64-bit
// compare-exchanges and shuffles take the SM's instruction slots from
// the other CTAs' blends. E = 8 on 128 threads (3 barriers, strides >=
// 256) ran 0.4 % faster than that and is the one built. The exchange
// buffer aliases the record area, which is free until the sort is done.
// Shared memory is 11 K_pad + 8 chunk words (47,104 B at K_pad = 1024,
// chunk 64): 4 CTAs a SM, as the 64-register cap allows. Inactive and
// empty slots skip the sort.
//
// Built with -fmad=false so that the per-pixel arithmetic rounds as the
// plain PyTorch version's separate operations do.

#include <cuda_runtime.h>
#include <math.h>

#include "bitonic.cuh"
#include "blend.cuh"

namespace {

using blend::kThreads;
using blend::kWarps;
// CTAs a SM must fit: caps a thread at 64 registers (a few spill), so
// that the 32 lane weights blend.cuh keeps in registers do not cost
// occupancy.
constexpr int kMinCtas = 4;

// E items a thread for rows of K_pad lanes: 8 up to 2,048 lanes, then 16,
// so that a row stays within the CTA's 256 threads.
template <int E>
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
  const blend::Lanes lanes = blend::lanes_at(smem, k_pad, smem + 11 * k_pad);
  int* s_rank = reinterpret_cast<int*>(smem + 10 * k_pad);  // by input lane
  // The sort's exchange buffer (n <= K_pad items of 8 B) aliases the
  // records, which land only after the sort.
  unsigned long long* xchg = reinterpret_cast<unsigned long long*>(smem);

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[slot], 0), k);
  const bool active = slot_active[slot] != 0 && count > 0;
  const int n_real = active ? count : 0;
  const size_t row = static_cast<size_t>(slot) * k;

  // ---- sort (depth, lane) in registers; rank[lane] = sorted position ----
  if (active) {
    int n = 32 * E;
    while (n < count) n <<= 1;
    const int nt = n / E;
    if (tid < nt) {
      unsigned long long x[E];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int p = tid * E + j;
        const unsigned int bits =
            p < count ? bitonic::order_bits(depth[row + p]) : 0xFFFFFFFFu;
        x[j] = (static_cast<unsigned long long>(bits) << 32) |
               static_cast<unsigned int>(p);
      }
      // Rows past 32 E items span nt / 32 warps; only those meet.
      bitonic::sort<E>(x, tid, nt, xchg, [nt]() {
        asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
      });
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int pos = tid * E + j;
        if (pos < count) s_rank[static_cast<int>(x[j] & 0xFFFFFFFFull)] = pos;
      }
    }
  }
  __syncthreads();

  // ---- records in input order to their sorted positions ----
  for (int l = tid; l < n_real; l += kThreads) {
    const size_t g = row + l;
    blend::store_lane(lanes, s_rank[l], mean2d[2 * g], mean2d[2 * g + 1],
                      conic[3 * g], conic[3 * g + 1], conic[3 * g + 2],
                      opacity[g], rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2],
                      depth[g]);
  }
  // Padding up to the last chunk the blend reaches reads 0 (depth 0: 0 *
  // inf is NaN).
  const int used =
      active ? min((count + chunk - 1) / chunk, k_pad / chunk) : 0;
  for (int s = n_real + tid; s < used * chunk; s += kThreads)
    blend::store_lane(lanes, s, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                      0.0f, 0.0f, 0.0f);

  // ---- chunked front-to-back blend, one thread per pixel ----
  const int n_run =
      blend::render_tile(lanes, origins, slot, used, count, chunk, out_rgb,
                         out_trans, out_depth, out_tdepth, out_processed);
  // Every input lane gets its contribution (0 where no chunk ran).
  const int ran = n_run * chunk;
  for (int l = tid; l < k; l += kThreads) {
    float v = 0.0f;
    if (l < n_real) {
      const int s = s_rank[l];
      if (s < ran) v = lanes.c[s].y;
    }
    out_contrib[row + l] = v;
  }
}

template <int E>
int launch(const float* mean2d, const float* conic, const float* rgb,
           const float* opacity, const float* depth, const float* origins,
           const int* counts, const int* slot_active, float* out_rgb,
           float* out_trans, float* out_depth, float* out_tdepth,
           int* out_processed, float* out_contrib, int r, int k, int k_pad,
           int chunk, cudaStream_t stream) {
  const size_t smem = (11 * static_cast<size_t>(k_pad) +
                       static_cast<size_t>(kWarps) * chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_plan_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (r > 0) {
    raster_plan_kernel<E><<<r, kThreads, smem, stream>>>(
        mean2d, conic, rgb, opacity, depth, origins, counts, slot_active,
        out_rgb, out_trans, out_depth, out_tdepth, out_processed,
        out_contrib, k, k_pad, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Inputs are contiguous float32
// (R, K, ...) bins plus origins (R, 2), counts and slot_active (R,) int32;
// k_pad is the power of two >= max(K, chunk), at most 4096. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a larger k_pad.
extern "C" int raster_plan_fused(
    const float* mean2d, const float* conic, const float* rgb,
    const float* opacity, const float* depth, const float* origins,
    const int* counts, const int* slot_active, float* out_rgb,
    float* out_trans, float* out_depth, float* out_tdepth,
    int* out_processed, float* out_contrib, int r, int k, int k_pad,
    int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RASTER_PLAN_LAUNCH(E)                                               \
  launch<E>(mean2d, conic, rgb, opacity, depth, origins, counts,            \
            slot_active, out_rgb, out_trans, out_depth, out_tdepth,         \
            out_processed, out_contrib, r, k, k_pad, chunk, s)
  if (k_pad <= 2048) return RASTER_PLAN_LAUNCH(8);
  if (k_pad == 4096) return RASTER_PLAN_LAUNCH(16);
#undef RASTER_PLAN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
