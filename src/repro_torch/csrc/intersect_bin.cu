// Sparse TAIT intersect and per-slot K-nearest binning, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference computes this layer in plain jnp:
// repro/core/intersect.py's TAIT masks over every (Gaussian, plan slot)
// pair, then repro/core/binning.py::build_tile_bins, a lax.top_k over all
// N Gaussians for every slot. Run densely on the card (float (N, R)
// offsets and masks, an int64 (R, N) key, torch.topk over all N a row)
// it took ~88 % of a frame's device time, although a Gaussian's tight box
// covers a handful of tiles and at most K Gaussians reach a slot's bins:
// nearly every test said no. Here each Gaussian visits only the tiles of
// its box, and each slot sorts only what reached it.
//
// Passes (kernels/intersect_bin.py launches them, and reads the pair
// total between count and emit to size the key buffer):
//   map     slot_of[tile] = slot + 1 for each active plan slot (a plan
//           holds a tile at most once: full_plan and sparse_plan take a
//           permutation of the tiles).
//   count   one thread a Gaussian. Its tiles are x in [floor(lo/16),
//           floor(hi/16)] and y alike, clamped to the grid: /16 is exact
//           in float32, and stage 1's strict lo < origin + 16 and
//           hi > origin hold on no tile outside that range. On each tile
//           of an active slot the float predicates of core/intersect.py,
//           each product, sum and difference rounded on its own as torch
//           rounds them (built with -fmad=false); then the cull (keep the
//           pair if prior >= threshold or the tile's gate is off) and the
//           DPES limit (depth <= limit[slot]). Per-slot atomics count the
//           pairs after the cull (raw_slots) and, of those, the pairs
//           within the limit (count_full); a plain store flags a slot
//           that had pairs before the cull; the stage-1 and culled totals
//           go once a warp. A Gaussian whose range holds more than
//           kSmallArea tiles is walked by its whole warp, a tile a lane,
//           so no one thread holds its warp.
//   scan    one CTA: the exclusive scan of count_full into int64 offsets
//           (offsets[R] is the pair total) and the culling's demotion of
//           slots that had pairs and kept none.
//   emit    the count pass again, writing each pair's key into its slot's
//           segment at an atomic cursor: the binning's key, (order bits of
//           depth << 32) | id as a signed int64, as core/binning.py builds
//           it. Keys in a slot are distinct, since ids are, so the
//           cursor's order does not matter.
//   select  one CTA a slot. A segment of at most K keys is sorted whole;
//           a longer one gives up the K keys at or below its K-th smallest
//           (an 8-bit radix select over the keys in unsigned order, 8
//           passes over the segment), which are sorted. The sort is
//           bitonic.cuh's network on 256 threads, E = pow2(count) / 256
//           items a thread (at least 1). Lanes past the slot's count take
//           the smallest ids outside its set, ascending, which is what
//           top-k of the masked row gives there; they all lie below
//           K + count < 2K, so a bitmap of the ids below 2K finds them.
//           Inactive slots have count 0 and get 0..K-1, invalid.
//
// A pair of a valid Gaussian has a finite depth (the preprocess marks
// valid only Gaussians in front of the near plane, from finite means), so
// every selected key is a valid lane, as in the dense binning.
//
// What bounds it: bytes. The Gaussian passes read ~40 B a Gaussian twice
// (44 MB at 1.1 M Gaussians), and the slot map, gates and limits from L2;
// each pair moves ~24 B through its atomics, the key's write and the
// select's reads (a slot longer than K reads its keys 9 times, from L2).
// At tens of millions of pairs a frame that is under 1 GB: under 0.3 ms at
// 3.35 TB/s. The design keeps to those passes: no (N, R) array exists,
// and no pair outside a Gaussian's box is tested. On the card the count
// and emit passes take 85 % of the time (2.37 of 2.79 ms at 1.1 M
// Gaussians and 23.8 M pairs, PERF.md): the per-slot atomics on the
// slots' counters and cursors, not the bytes, set it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "bitonic.cuh"

namespace {

constexpr int kTile = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPairThreads = 256;
constexpr int kSmallArea = 16;
constexpr int kScanThreads = 1024;
constexpr int kSelectThreads = 256;
constexpr int kMaxPad = 4096;  // the longest sorted row: E = 16
constexpr unsigned long long kSignBit = 1ull << 63;

}  // namespace

// The count and emit passes' inputs, by value (kernels/intersect_bin.py::
// Pairs). keep and gate are both null without a cull; limit is null
// without DPES.
struct IntersectPairs {
  const float* mean2d;         // (N, 2)
  const float* half_wh;        // (N, 2) the tight box's half extents
  const float* minor_axis;     // (N, 2)
  const float* r_minor;        // (N,)
  const float* depth;          // (N,)
  const unsigned char* valid;  // (N,)
  const unsigned char* keep;   // (N,) prior >= threshold
  const unsigned char* gate;   // (T,) the cull applies on this tile
  const float* limit;          // (R,) DPES depth limit
  const int* tile_ids;         // (R,)
  const unsigned char* slot_active;  // (R,)
  int n, tiles_x, tiles_y, r;
  float circumradius;          // float32(TILE_CIRCUMRADIUS)
};

namespace {

// Views of the zeroed int32 workspace: T + 4 R + 2 words
// (kernels/intersect_bin.py::workspace_words).
struct Workspace {
  int* slot_of;      // (T,) slot + 1 of the tile's active slot, 0 for none
  int* post;         // (R,) pairs after the cull: raw_slots
  int* full;         // (R,) of those, pairs within the DPES limit
  int* had;          // (R,) 1 where a pair passed both stages before the cull
  int* cursor;       // (R,) the emit pass's cursors
  unsigned* totals;  // stage-1 pairs, culled pairs
  __host__ __device__ Workspace(int* ws, int t, int r)
      : slot_of(ws), post(ws + t), full(ws + t + r), had(ws + t + 2 * r),
        cursor(ws + t + 3 * r),
        totals(reinterpret_cast<unsigned*>(ws + t + 4 * r)) {}
};

// A Gaussian's box and what the predicates read; area 0 visits nothing.
struct Splat {
  float mx, my, lox, loy, hix, hiy, ax, ay, rmin, depth;
  int keep, x0, y0, nx, area;
};

__device__ __forceinline__ Splat load_splat(const IntersectPairs& p,
                                            int g) {
  Splat s;
  s.area = 0;
  if (g >= p.n || !p.valid[g]) return s;
  s.mx = p.mean2d[2 * g];
  s.my = p.mean2d[2 * g + 1];
  const float hx = p.half_wh[2 * g], hy = p.half_wh[2 * g + 1];
  s.lox = __fsub_rn(s.mx, hx);
  s.loy = __fsub_rn(s.my, hy);
  s.hix = __fadd_rn(s.mx, hx);
  s.hiy = __fadd_rn(s.my, hy);
  if (isnan(s.lox) || isnan(s.loy) || isnan(s.hix) || isnan(s.hiy))
    return s;
  const float x0 = fmaxf(floorf(s.lox * 0.0625f), 0.0f);
  const float y0 = fmaxf(floorf(s.loy * 0.0625f), 0.0f);
  const float x1 = fminf(floorf(s.hix * 0.0625f),
                         static_cast<float>(p.tiles_x - 1));
  const float y1 = fminf(floorf(s.hiy * 0.0625f),
                         static_cast<float>(p.tiles_y - 1));
  if (!(x1 >= x0) || !(y1 >= y0)) return s;
  s.x0 = static_cast<int>(x0);
  s.y0 = static_cast<int>(y0);
  s.nx = static_cast<int>(x1) - s.x0 + 1;
  s.area = s.nx * (static_cast<int>(y1) - s.y0 + 1);
  s.ax = p.minor_axis[2 * g];
  s.ay = p.minor_axis[2 * g + 1];
  s.rmin = p.r_minor[g];
  s.depth = p.depth[g];
  s.keep = p.keep != nullptr ? p.keep[g] : 1;
  return s;
}

__device__ __forceinline__ Splat shfl_splat(const Splat& s, int src) {
  Splat b;
  b.mx = __shfl_sync(kFull, s.mx, src);
  b.my = __shfl_sync(kFull, s.my, src);
  b.lox = __shfl_sync(kFull, s.lox, src);
  b.loy = __shfl_sync(kFull, s.loy, src);
  b.hix = __shfl_sync(kFull, s.hix, src);
  b.hiy = __shfl_sync(kFull, s.hiy, src);
  b.ax = __shfl_sync(kFull, s.ax, src);
  b.ay = __shfl_sync(kFull, s.ay, src);
  b.rmin = __shfl_sync(kFull, s.rmin, src);
  b.depth = __shfl_sync(kFull, s.depth, src);
  b.keep = __shfl_sync(kFull, s.keep, src);
  b.x0 = __shfl_sync(kFull, s.x0, src);
  b.y0 = __shfl_sync(kFull, s.y0, src);
  b.nx = __shfl_sync(kFull, s.nx, src);
  b.area = __shfl_sync(kFull, s.area, src);
  return b;
}

// The binning's key in unsigned order: the signed key
// (order bits << 32) | id with its sign bit flipped.
__device__ __forceinline__ unsigned long long unsigned_key(float depth,
                                                           int id) {
  const unsigned b = __float_as_uint(depth);
  const unsigned hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(hi) << 32) |
         static_cast<unsigned>(id);
}

// Tile ``i`` of Gaussian ``s``'s range (row-major in its box).
template <bool kEmit>
__device__ __forceinline__ void visit(const IntersectPairs& p,
                                      const Workspace& w, const Splat& s,
                                      int g, int i,
                                      const long long* offsets,
                                      long long* keys, unsigned& cand,
                                      unsigned& culled) {
  const int tx = s.x0 + i % s.nx, ty = s.y0 + i / s.nx;
  const int tile = ty * p.tiles_x + tx;
  const int slot = w.slot_of[tile] - 1;
  if (slot < 0) return;
  const float ox = static_cast<float>(tx * kTile);
  const float oy = static_cast<float>(ty * kTile);
  // Stage 1: intersect.tait_stage1_mask.
  if (!(s.lox < ox + kTile && s.hix > ox && s.loy < oy + kTile &&
        s.hiy > oy))
    return;
  ++cand;
  // Stage 2: intersect.tait_stage2_keep, d = center - mean.
  const float dx = __fsub_rn(ox + 0.5f * kTile, s.mx);
  const float dy = __fsub_rn(oy + 0.5f * kTile, s.my);
  const float along = __fadd_rn(__fmul_rn(dx, s.ax), __fmul_rn(dy, s.ay));
  if (!(__fsub_rn(fabsf(along), p.circumradius) <= s.rmin)) return;
  if (p.keep != nullptr) {
    if (!kEmit) w.had[slot] = 1;
    if (!s.keep && p.gate[tile]) {
      ++culled;
      return;
    }
  }
  if (!kEmit) atomicAdd(w.post + slot, 1);
  if (p.limit != nullptr && !(s.depth <= p.limit[slot])) return;
  if (kEmit) {
    const int at = atomicAdd(w.cursor + slot, 1);
    keys[offsets[slot] + at] =
        static_cast<long long>(unsigned_key(s.depth, g) ^ kSignBit);
  } else {
    atomicAdd(w.full + slot, 1);
  }
}

__global__ void intersect_map_kernel(const int* __restrict__ tile_ids,
                                const unsigned char* __restrict__ active,
                                int r, int tiles, int* __restrict__ slot_of) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= r || !active[s]) return;
  const int t = tile_ids[s];
  if (t >= 0 && t < tiles) slot_of[t] = s + 1;
}

template <bool kEmit>
__global__ void __launch_bounds__(kPairThreads) intersect_pairs_kernel(
    IntersectPairs p, Workspace w, const long long* __restrict__ offsets,
    long long* __restrict__ keys) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kPairThreads + threadIdx.x;
  const Splat s = load_splat(p, g);
  unsigned cand = 0, culled = 0;
  if (s.area <= kSmallArea)
    for (int i = 0; i < s.area; ++i)
      visit<kEmit>(p, w, s, g, i, offsets, keys, cand, culled);
  // Large boxes (near the camera): the whole warp walks each in turn.
  unsigned big = __ballot_sync(kFull, s.area > kSmallArea);
  while (big) {
    const int src = __ffs(big) - 1;
    big &= big - 1;
    const Splat b = shfl_splat(s, src);
    const int bg = __shfl_sync(kFull, g, src);
    for (int i = lane; i < b.area; i += 32)
      visit<kEmit>(p, w, b, bg, i, offsets, keys, cand, culled);
  }
  if (!kEmit) {
    cand = __reduce_add_sync(kFull, cand);
    culled = __reduce_add_sync(kFull, culled);
    if (lane == 0 && cand) atomicAdd(w.totals, cand);
    if (lane == 0 && culled) atomicAdd(w.totals + 1, culled);
  }
}

// One CTA: offsets[s] = count_full[0..s) for s <= R; the culling's
// demotion into active_out.
__global__ void __launch_bounds__(kScanThreads) intersect_scan_kernel(
    Workspace w, const unsigned char* __restrict__ active, int r,
    long long* __restrict__ offsets, unsigned char* __restrict__ active_out) {
  __shared__ long long warp_sum[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (r + kScanThreads - 1) / kScanThreads;
  const int b = min(t * per, r), e = min(b + per, r);
  long long sum = 0;
  for (int i = b; i < e; ++i) sum += w.full[i];
  long long inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long v = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    warp_sum[lane] = v;
  }
  __syncthreads();
  long long run = inc - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = b; i < e; ++i) {
    offsets[i] = run;
    run += w.full[i];
    active_out[i] = active[i] && !(w.had[i] && w.post[i] == 0);
  }
  if (t == kScanThreads - 1) offsets[r] = run;
}

// The K-th smallest of the segment's c > K distinct keys (unsigned order):
// 8 passes of an 8-bit digit histogram over the keys that match the
// digits found so far.
__device__ unsigned long long radix_select(const long long* seg, int c,
                                           int k, unsigned* hist) {
  __shared__ unsigned s_digit, s_before;
  const int t = threadIdx.x;
  unsigned long long prefix = 0, mask = 0;
  unsigned rem = static_cast<unsigned>(k);
  for (int shift = 56; shift >= 0; shift -= 8) {
    hist[t] = 0;  // kSelectThreads == 256 bins
    __syncthreads();
    for (int i = t; i < c; i += kSelectThreads) {
      const unsigned long long u =
          static_cast<unsigned long long>(seg[i]) ^ kSignBit;
      if ((u & mask) == prefix)
        atomicAdd(hist + ((u >> shift) & 0xFF), 1u);
    }
    __syncthreads();
    if (t < 32) {
      // Lane l holds bins 8l .. 8l + 7; the digit is the first bin at
      // which the running count reaches rem.
      unsigned local = 0;
      for (int j = 0; j < 8; ++j) local += hist[8 * t + j];
      unsigned inc = local;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, inc, o);
        if (t >= o) inc += y;
      }
      unsigned acc = inc - local;
      if (acc < rem && rem <= inc) {
        for (int j = 0; j < 8; ++j) {
          const unsigned h = hist[8 * t + j];
          if (acc + h >= rem) {
            s_digit = 8 * t + j;
            s_before = acc;
            break;
          }
          acc += h;
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(s_digit) << shift;
    mask |= 0xFFull << shift;
    rem -= s_before;
  }
  return prefix;
}

// Sort the m selected keys (sel, unsigned order) and write their ids as
// the slot's first m lanes. sel is reused as the network's exchange
// buffer; every thread of the CTA calls this.
template <int E>
__device__ __forceinline__ void sort_lanes(unsigned long long* sel, int m,
                                           int* idx, unsigned char* valid) {
  const int t = threadIdx.x;
  unsigned long long x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int q = t * E + j;
    x[j] = q < m ? sel[q] : ~0ull;
  }
  __syncthreads();
  bitonic::sort<E>(x, t, kSelectThreads, sel, []() { __syncthreads(); });
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int q = t * E + j;
    if (q < m) {
      idx[q] = static_cast<int>(x[j] & 0xffffffffull);
      valid[q] = 1;
    }
  }
}

__global__ void __launch_bounds__(kSelectThreads) bin_select_kernel(
    const long long* __restrict__ keys, const long long* __restrict__ offsets,
    const int* __restrict__ full, int r, int k, int capacity,
    int* __restrict__ indices, unsigned char* __restrict__ valid,
    int* __restrict__ count, int* __restrict__ overflow) {
  extern __shared__ unsigned long long smem[];
  __shared__ unsigned hist[kSelectThreads];
  __shared__ unsigned s_fill;
  const int slot = blockIdx.x, t = threadIdx.x;
  if (slot >= r) return;
  const int c = full[slot];
  const int m = min(c, k);
  const int n_pad = max(kSelectThreads, 1 << (32 - __clz(max(k, 1) - 1)));
  unsigned long long* sel = smem;                               // n_pad
  unsigned* member = reinterpret_cast<unsigned*>(smem + n_pad);  // 2K bits
  const int words = (2 * k + 31) / 32;
  const long long* seg = keys + offsets[slot];
  int* idx = indices + static_cast<size_t>(slot) * k;
  unsigned char* val = valid + static_cast<size_t>(slot) * k;

  for (int i = t; i < words; i += kSelectThreads) member[i] = 0;
  if (t == 0) s_fill = 0;
  __syncthreads();
  if (c <= k) {
    for (int i = t; i < c; i += kSelectThreads) {
      const unsigned long long u =
          static_cast<unsigned long long>(seg[i]) ^ kSignBit;
      sel[i] = u;
      const unsigned id = static_cast<unsigned>(u);
      if (id < 2u * k) atomicOr(member + (id >> 5), 1u << (id & 31));
    }
  } else {
    const unsigned long long kth = radix_select(seg, c, k, hist);
    for (int i = t; i < c; i += kSelectThreads) {
      const unsigned long long u =
          static_cast<unsigned long long>(seg[i]) ^ kSignBit;
      if (u <= kth) sel[atomicAdd(&s_fill, 1u)] = u;
    }
  }
  __syncthreads();
  const int rows = max(kSelectThreads, 1 << (32 - __clz(max(m, 1) - 1)));
  if (m > 0) {
    switch (rows / kSelectThreads) {
      case 1: sort_lanes<1>(sel, m, idx, val); break;
      case 2: sort_lanes<2>(sel, m, idx, val); break;
      case 4: sort_lanes<4>(sel, m, idx, val); break;
      case 8: sort_lanes<8>(sel, m, idx, val); break;
      default: sort_lanes<16>(sel, m, idx, val); break;
    }
  }
  // Lanes m .. K-1: the smallest ids outside the slot's set, ascending.
  if (m < k && t < 32) {
    const int need = k - m;
    int base = 0;
    for (int w0 = 0; w0 < words && base < need; w0 += 32) {
      const int wi = w0 + t;
      unsigned free_ids = wi < words ? ~member[wi] : 0u;
      const int cnt = __popc(free_ids);
      int inc = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, o);
        if (t >= o) inc += y;
      }
      int rank = base + inc - cnt;
      while (free_ids && rank < need) {
        const int bit = __ffs(free_ids) - 1;
        free_ids &= free_ids - 1;
        idx[m + rank] = wi * 32 + bit;
        val[m + rank] = 0;
        ++rank;
      }
      base += __shfl_sync(kFull, inc, 31);
    }
  }
  if (t == 0) {
    count[slot] = min(c, capacity);
    overflow[slot] = max(c - capacity, 0);
  }
}

int grid_of(int n, int threads) {
  return std::max(1, (n + threads - 1) / threads);
}

}  // namespace

// Plain C entry points (loaded with ctypes), all on ``stream``, none of
// them synchronising. ``ws`` is the zeroed int32 workspace of T + 4 R + 2
// words; offsets (R + 1,) int64. Each returns cudaGetLastError().

// Map, count and scan: offsets, raw_slots (ws[T:T+R]), the stage-1 and
// culled totals (ws[T+4R:]) and the slots' flags after the cull.
extern "C" int intersect_bin_count(IntersectPairs p, int* ws,
                                   long long* offsets,
                                   unsigned char* active_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = p.tiles_x * p.tiles_y;
  const Workspace w(ws, tiles, p.r);
  intersect_map_kernel<<<grid_of(p.r, 256), 256, 0, s>>>(
      p.tile_ids, p.slot_active, p.r, tiles, w.slot_of);
  intersect_pairs_kernel<false>
      <<<grid_of(p.n, kPairThreads), kPairThreads, 0, s>>>(p, w, nullptr,
                                                           nullptr);
  intersect_scan_kernel<<<1, kScanThreads, 0, s>>>(w, p.slot_active, p.r,
                                                    offsets, active_out);
  return static_cast<int>(cudaGetLastError());
}

// Emit: keys (offsets[R],) int64, each slot's pairs in its segment.
extern "C" int intersect_bin_emit(IntersectPairs p, int* ws,
                                  const long long* offsets, long long* keys,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w(ws, p.tiles_x * p.tiles_y, p.r);
  intersect_pairs_kernel<true>
      <<<grid_of(p.n, kPairThreads), kPairThreads, 0, s>>>(p, w, offsets,
                                                           keys);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one select CTA: the padded row of keys and the bitmap
// of the ids below 2K.
extern "C" int intersect_bin_select_smem(int k) {
  const int kk = k > 1 ? k : 1;
  int n_pad = 1;
  while (n_pad < kk) n_pad <<= 1;
  if (n_pad < kSelectThreads) n_pad = kSelectThreads;
  return n_pad * 8 + (2 * kk + 31) / 32 * 4;
}

// Select: (R, K) indices and valid, (R,) count and overflow, from the
// count_full[s] keys of each slot's segment. 1 <= K <= kMaxPad.
extern "C" int intersect_bin_select(const long long* keys,
                                    const long long* offsets, const int* full,
                                    int r, int k, int capacity, int* indices,
                                    unsigned char* valid, int* count,
                                    int* overflow, void* stream) {
  if (k < 1 || k > kMaxPad) return static_cast<int>(cudaErrorInvalidValue);
  bin_select_kernel<<<std::max(r, 1), kSelectThreads,
                  intersect_bin_select_smem(k),
                  static_cast<cudaStream_t>(stream)>>>(
      keys, offsets, full, r, k, capacity, indices, valid, count, overflow);
  return static_cast<int>(cudaGetLastError());
}
