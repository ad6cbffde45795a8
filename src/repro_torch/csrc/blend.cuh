// The chunked front-to-back alpha blend shared by the raster kernels
// (raster_plan.cu, the fused sort + blend; raster_tile.cu, the blend over
// bins binning already sorted). One CTA renders one 16x16 tile with one
// thread per pixel; the tile's lanes sit in shared memory in blend order,
// each lane's record packed as float4 {mx, my, ca, cb}, float4 {cc, op,
// r, g} and float2 {b, depth}, so a lane reaches every thread of a warp
// as three broadcast vector loads.
//
// Semantics are the reference's (repro/kernels/raster_tile.py): alpha =
// min(o e^power, 0.99), alpha < 1/255 -> 0, a pixel is done for good once
// its transmittance would fall below 1e-4 (the lane that would take it
// there is not blended), and the CTA stops once every pixel is done
// (__syncthreads_or), as the Pallas kernel's chunk_cond does; before
// that, a warp whose pixels are all done skips a chunk's arithmetic,
// which could not change its pixels or its zero weights. Each lane's
// contribution (the sum over the 256 pixels of alpha * T_before) is
// reduced in a fixed order, so a run repeats bit for bit: inside a warp
// by the xor butterfly's tree (pairs of threads 16 apart first, then 8,
// 4, 2, 1), then the eight warp partials in order. A thread keeps the
// weights of 32 consecutive lanes in registers and reduces them with the
// butterfly transposed (each step halves the lanes a thread holds, 31
// shuffles per 32 lanes), so thread t ends with lane t's warp partial;
// lanes past the last full group of 32 take the butterfly one by one.
// Both orders pair the same threads in the same tree, and float addition
// is commutative, so the partials are the same bits either way.
//
// Two pixels or four a thread, and groups of 16 or 8 lanes, were measured
// slower in both kernels (PERF.md); the kernels cap a thread at 64
// registers (kMinCtas), which the 32 lane weights need.

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

// A tile's lanes in shared memory, in blend order. ``c[j].y`` (depth) is
// overwritten with lane j's contribution once its chunk has run.
struct Lanes {
  float4* a;    // {mx, my, ca, cb}
  float4* b;    // {cc, op, r, g}
  float2* c;    // {b, depth}
  float* part;  // [kWarps][chunk] per-warp partial contributions
};

// The records of ``k`` lanes at ``base`` (16-byte aligned): a, b and c in
// that order, 10 floats a lane.
__device__ __forceinline__ Lanes lanes_at(float* base, int k, float* part) {
  return {reinterpret_cast<float4*>(base),
          reinterpret_cast<float4*>(base + 4 * k),
          reinterpret_cast<float2*>(base + 8 * k), part};
}

__device__ __forceinline__ void store_lane(const Lanes& s, int l, float mx,
                                           float my, float ca, float cb,
                                           float cc, float op, float r,
                                           float g, float b, float depth) {
  s.a[l] = make_float4(mx, my, ca, cb);
  s.b[l] = make_float4(cc, op, r, g);
  s.c[l] = make_float2(b, depth);
}

// One pixel's accumulators.
struct Pixel {
  float c0, c1, c2, t_run, d_acc, w_acc, td_max;
};

// One chunk's running sums for one pixel.
struct Chunk {
  float cp, t_new, tp, sc0, sc1, sc2, sd, sw;
};

// Blend lane j into the pixel at (px, py); returns its weight
// alpha * T_before (0 where the lane does not blend).
__device__ __forceinline__ float blend_lane(const Lanes& s, int j, float px,
                                            float py, bool done, Pixel& p,
                                            Chunk& c) {
  const float4 a = s.a[j];
  const float4 b = s.b[j];
  const float2 e = s.c[j];
  const float dx = px - a.x;
  const float dy = py - a.y;
  const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
  float alpha = b.y * expf(power);
  alpha = (alpha >= kAlphaMin) ? fminf(alpha, kAlphaMax) : 0.0f;
  const float t_before = p.t_run * c.cp;
  c.cp = c.cp * (1.0f - alpha);
  c.tp = p.t_run * c.cp;
  const bool blend = (c.tp >= kTEps) && !done;
  const float w = blend ? alpha * t_before : 0.0f;
  c.sc0 += w * b.z;
  c.sc1 += w * b.w;
  c.sc2 += w * e.x;
  c.sd += w * e.y;
  c.sw += w;
  if (blend && alpha > 0.0f) p.td_max = fmaxf(p.td_max, e.y);
  c.t_new = fminf(c.t_new, blend ? c.tp : p.t_run);
  return w;
}

// One step of the transposed butterfly, for thread bit H: of the 2H
// lanes w[0 .. 2H) a thread holds, it keeps the H whose bit H equals its
// own and adds its partner's (thread ^ H) values for them. H is a
// template argument so that every index is a constant and w stays in
// registers.
template <int H>
__device__ __forceinline__ void transposed_step(float* w) {
  const bool upper = (threadIdx.x & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = w[i], hi = w[i + H];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    w[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The xor butterfly transposed: thread t of the warp holds w[q] for 32
// lanes q and gets back the sum over the warp's threads of lane t's
// weight.
__device__ __forceinline__ float transposed_sum32(float (&w)[32]) {
  transposed_step<16>(w);
  transposed_step<8>(w);
  transposed_step<4>(w);
  transposed_step<2>(w);
  transposed_step<1>(w);
  return w[0];
}

// Blend the first ``used`` chunks of ``chunk`` lanes (chunk <= 256) into
// the pixel centred at (px, py); returns the chunks run (the same in
// every thread). Every thread of the CTA must call it.
__device__ __forceinline__ int blend_chunks(const Lanes& s, float px,
                                            float py, int used, int chunk,
                                            Pixel& p) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  p = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f};
  bool done = false;
  int n_run = 0;
  for (int i = 0; i < used; ++i) {
    if (!__syncthreads_or(!done)) break;
    ++n_run;
    const int base = i * chunk;
    float* part = s.part + warp * chunk;
    // A warp whose pixels are all done takes nothing from this chunk: its
    // weights would all be 0 and its pixels' sums would not move (the
    // records are finite). It skips the arithmetic and stores the zero
    // partials the sums would give.
    if (!__any_sync(0xffffffffu, !done)) {
      for (int l = lane; l < chunk; l += 32) part[l] = 0.0f;
    } else {
      Chunk c = {1.0f, p.t_run, p.t_run, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      int jj = 0;
      for (; jj + 32 <= chunk; jj += 32) {
        float w[32];
        bool any = false;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          w[q] = blend_lane(s, base + jj + q, px, py, done, p, c);
          any = any || w[q] != 0.0f;
        }
        // A warp whose weights are all 0 stores 0, as the sum would.
        part[jj + lane] =
            __any_sync(0xffffffffu, any) ? transposed_sum32(w) : 0.0f;
      }
      for (; jj < chunk; ++jj) {
        float v = blend_lane(s, base + jj, px, py, done, p, c);
        if (__any_sync(0xffffffffu, v != 0.0f)) {
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        if (lane == 0) part[jj] = v;
      }
      p.c0 += c.sc0;
      p.c1 += c.sc1;
      p.c2 += c.sc2;
      p.d_acc += c.sd;
      p.w_acc += c.sw;
      p.t_run = c.t_new;
      done = done || (c.tp < kTEps);
    }
    __syncthreads();
    for (int l = tid; l < chunk; l += kThreads) {
      float sum = 0.0f;
      for (int wi = 0; wi < kWarps; ++wi) sum += s.part[wi * chunk + l];
      s.c[base + l].y = sum;  // this chunk's depths are not read again
    }
  }
  __syncthreads();
  return n_run;
}

// Render this thread's pixel of tile ``slot`` (origins (R, 2) float32)
// from the first ``used`` chunks of its lanes: write its images and,
// from thread 0, the tile's processed pairs min(chunks_run * chunk,
// count). Returns the chunks run. Every thread of the CTA must call it.
__device__ __forceinline__ int render_tile(const Lanes& s,
                                           const float* origins, int slot,
                                           int used, int count, int chunk,
                                           float* out_rgb, float* out_trans,
                                           float* out_depth,
                                           float* out_tdepth,
                                           int* out_processed) {
  const int tid = threadIdx.x;
  const float px =
      (static_cast<float>(tid % kTile) + origins[2 * slot]) + 0.5f;
  const float py =
      (static_cast<float>(tid / kTile) + origins[2 * slot + 1]) + 0.5f;
  Pixel p;
  const int n_run = blend_chunks(s, px, py, used, chunk, p);
  const size_t pix = static_cast<size_t>(slot) * kThreads + tid;
  out_rgb[3 * pix] = p.c0;
  out_rgb[3 * pix + 1] = p.c1;
  out_rgb[3 * pix + 2] = p.c2;
  out_trans[pix] = p.t_run;
  out_depth[pix] = p.d_acc / fmaxf(p.w_acc, 1e-8f);
  out_tdepth[pix] = p.td_max;
  if (tid == 0) out_processed[slot] = min(n_run * chunk, count);
  return n_run;
}

}  // namespace blend
