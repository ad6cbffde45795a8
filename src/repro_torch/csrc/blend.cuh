// The chunked front-to-back alpha blend shared by the raster kernels
// (raster_plan.cu, the fused sort + blend; raster_tile.cu, the blend over
// bins binning already sorted). One CTA renders one 16x16 tile with one
// thread per pixel; the tile's lanes sit in shared memory, one float
// array per attribute, in blend order.
//
// Semantics are the reference's (repro/kernels/raster_tile.py): alpha =
// min(o e^power, 0.99), alpha < 1/255 -> 0, a pixel is done for good once
// its transmittance would fall below 1e-4 (the lane that would take it
// there is not blended), and the CTA stops once every pixel is done
// (__syncthreads_or), as the Pallas kernel's chunk_cond does. Each lane's
// contribution (the sum over the 256 pixels of alpha * T_before) is
// reduced in a fixed order (xor-shuffles in the warp, then the eight warp
// partials in order), so a run repeats bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace blend {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// A tile's lanes in shared memory, in blend order. ``depth`` is
// overwritten with each lane's contribution once its chunk has run.
struct Lanes {
  float* depth;
  const float* op;
  const float* mx;
  const float* my;
  const float* ca;
  const float* cb;
  const float* cc;
  const float* r;
  const float* g;
  const float* b;
  float* part;  // [kWarps][chunk] per-warp partial contributions
};

// One pixel's accumulators after the blend; ``n_run`` (chunks run) is the
// same in every thread of the CTA.
struct Pixel {
  float c0, c1, c2, t_run, d_acc, w_acc, td_max;
  int n_run;
};

// Blend the first ``used`` chunks of ``chunk`` lanes (chunk <= kThreads)
// for the pixel at (px, py). Every thread of the CTA must call it.
__device__ __forceinline__ Pixel blend_chunks(const Lanes& s, float px,
                                              float py, int used,
                                              int chunk) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  Pixel p = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0};
  bool done = false;
  for (int i = 0; i < used; ++i) {
    if (!__syncthreads_or(!done)) break;
    ++p.n_run;
    float cp = 1.0f, t_new = p.t_run, tp = p.t_run;
    float sc0 = 0.0f, sc1 = 0.0f, sc2 = 0.0f, sd = 0.0f, sw = 0.0f;
    for (int jj = 0; jj < chunk; ++jj) {
      const int j = i * chunk + jj;
      const float dx = px - s.mx[j];
      const float dy = py - s.my[j];
      const float power =
          -0.5f * (s.ca[j] * dx * dx + s.cc[j] * dy * dy) - s.cb[j] * dx * dy;
      float alpha = s.op[j] * expf(power);
      alpha = (alpha >= kAlphaMin) ? fminf(alpha, kAlphaMax) : 0.0f;
      const float t_before = p.t_run * cp;
      cp = cp * (1.0f - alpha);
      tp = p.t_run * cp;
      const bool blend = (tp >= kTEps) && !done;
      const float w = blend ? alpha * t_before : 0.0f;
      sc0 += w * s.r[j];
      sc1 += w * s.g[j];
      sc2 += w * s.b[j];
      sd += w * s.depth[j];
      sw += w;
      if (blend && alpha > 0.0f) p.td_max = fmaxf(p.td_max, s.depth[j]);
      t_new = fminf(t_new, blend ? tp : p.t_run);
      float v = w;
      if (__any_sync(0xffffffffu, v != 0.0f)) {
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) s.part[warp * chunk + jj] = v;
    }
    p.c0 += sc0;
    p.c1 += sc1;
    p.c2 += sc2;
    p.d_acc += sd;
    p.w_acc += sw;
    p.t_run = t_new;
    done = done || (tp < kTEps);
    __syncthreads();
    if (tid < chunk) {
      float sum = 0.0f;
      for (int wi = 0; wi < kWarps; ++wi) sum += s.part[wi * chunk + tid];
      s.depth[i * chunk + tid] = sum;  // this chunk's depths are not read again
    }
  }
  __syncthreads();
  return p;
}

// The pixel of tile ``slot`` that thread ``threadIdx.x`` renders: its
// centre in image coordinates (x, y), origins being (R, 2) float32.
__device__ __forceinline__ float2 pixel_centre(const float* origins,
                                               int slot) {
  const int tid = threadIdx.x;
  return make_float2(
      (static_cast<float>(tid % kTile) + origins[2 * slot]) + 0.5f,
      (static_cast<float>(tid / kTile) + origins[2 * slot + 1]) + 0.5f);
}

// Write one pixel's images and, from thread 0, the tile's processed pairs
// min(chunks_run * chunk, count).
__device__ __forceinline__ void store_pixel(const Pixel& p, int slot,
                                            int count, int chunk,
                                            float* out_rgb, float* out_trans,
                                            float* out_depth,
                                            float* out_tdepth,
                                            int* out_processed) {
  const size_t pix = static_cast<size_t>(slot) * kThreads + threadIdx.x;
  out_rgb[3 * pix] = p.c0;
  out_rgb[3 * pix + 1] = p.c1;
  out_rgb[3 * pix + 2] = p.c2;
  out_trans[pix] = p.t_run;
  out_depth[pix] = p.d_acc / fmaxf(p.w_acc, 1e-8f);
  out_tdepth[pix] = p.td_max;
  if (threadIdx.x == 0) out_processed[slot] = min(p.n_run * chunk, count);
}

}  // namespace blend
