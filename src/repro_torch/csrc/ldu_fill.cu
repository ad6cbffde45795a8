// The LDU's tile -> block fills (paper Sec. V-B) on the device, for
// Hopper (sm_90a).
//
// Replaces the reference's on-device scans, which are not Pallas kernels:
// repro/core/load_balance.py::greedy_fill (a lax.scan, the paper's
// capacity fill) and the "dynamic" scan of ldu_schedule (next slot to the
// least-loaded block). The port used to copy the (R,) workload to the host
// and scan it there; this kernel keeps the schedule on the device, so a
// frame's LDU stage no longer waits for intersect and bin to drain.
//
// Semantics (float32, in the reference's order of operations; nvcc runs
// with -fmad=false and IEEE division, so each step rounds as numpy's
// float32 scalars do in the plain version, kernels/ldu_fill.py):
//   total   = sum of the active workloads, each as its float32 value,
//             summed exactly in int64 and rounded to float32 once;
//   w_ideal = max(total / B, 1), n_avg = max(n_active / B, 1),
//   cap     = (1 + 1 / n_avg) * w_ideal;
//   greedy:  a slot joins the current block when acc[cur] + w <= cap,
//            else the first block in cyclic order from cur + 1 with room,
//            else the least-loaded block (lowest index on ties, as
//            np.argmin / jnp.argmin);
//   dynamic: every slot goes to the least-loaded block.
// Inactive slots get -1 and change nothing.
//
// What bounds it: the dependency chain. Each active slot's decision needs
// the previous slot's accumulators, so the scan is serial: one step per
// active slot, whose least time is a float add and a compare. One CTA of
// one warp; slots go by in groups of 32, one per lane, a ballot of the
// group's active flags gives the slots to place, and they are placed one
// a step, each step's workload shuffled in from its lane one step ahead.
// The current block's accumulator lives in a register every lane holds
// alike; the accumulators of all blocks live in shared memory, lane l
// owning blocks l, l + 32, ..., and only the owner ever reads or writes a
// block's entry; lanes agree through warp votes, reductions and shuffles
// alone (no barrier). A deferral takes one min-reduce of the fitting
// blocks' cyclic rank (j - cur - 1) mod B and, where none fits, an argmin
// of (acc, index) as two min-reduces over order-preserving keys.
// Workloads and flags are staged through shared memory in coalesced
// chunks, each lane staging the slots it later reads; block ids go out
// one coalesced store per group.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 1024;   // slots staged per chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

// Unsigned key with the order of the float32 value (no NaN and no -0
// occur: accumulators start at +0 and add integer values).
__device__ __forceinline__ unsigned order_key(float a) {
  const unsigned u = __float_as_uint(a);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Least (key, block) over the lane's own blocks: the first of equal keys.
__device__ __forceinline__ void lane_least(const float* s_acc, int b,
                                           int lane, unsigned& key,
                                           unsigned& j_best) {
  key = kNone;
  j_best = kNone;
  for (int j = lane; j < b; j += kWarp) {
    const unsigned k = order_key(s_acc[j]);
    if (k < key) {
      key = k;
      j_best = static_cast<unsigned>(j);
    }
  }
}

// The warp's least-loaded block, lowest index among equal loads.
__device__ __forceinline__ int warp_least(unsigned key, unsigned j_best) {
  const unsigned least = __reduce_min_sync(kFull, key);
  return static_cast<int>(
      __reduce_min_sync(kFull, key == least ? j_best : kNone));
}

// Greedy deferral of a slot of workload w that does not fit block cur:
// the fitting block of least cyclic rank (j - cur - 1) mod b, else the
// least-loaded block. Writes block cur's accumulator back first; leaves
// cur and acc_cur (alike in all lanes) at the chosen block, w included.
__device__ __forceinline__ int defer(float* s_acc, int b, int lane, float cap,
                                     float w, int& cur, float& acc_cur) {
  if (lane == (cur & (kWarp - 1))) s_acc[cur] = acc_cur;
  unsigned rank = kNone;
  for (int j = lane; j < b; j += kWarp) {
    if (s_acc[j] + w <= cap) {
      rank = min(rank, static_cast<unsigned>((j - cur - 1 + b) % b));
    }
  }
  rank = __reduce_min_sync(kFull, rank);
  int tgt;
  if (rank != kNone) {
    tgt = (cur + 1 + static_cast<int>(rank)) % b;
  } else {
    unsigned key, j_best;
    lane_least(s_acc, b, lane, key, j_best);
    tgt = warp_least(key, j_best);
  }
  float v = 0.0f;
  if (lane == (tgt & (kWarp - 1))) v = s_acc[tgt];
  acc_cur = __shfl_sync(kFull, v, tgt & (kWarp - 1)) + w;
  cur = tgt;
  return tgt;
}

__global__ void __launch_bounds__(kWarp) ldu_fill_kernel(
    const int* __restrict__ workload, const uint8_t* __restrict__ active,
    int* __restrict__ block_of, int r, int b, int dynamic) {
  extern __shared__ float smem[];
  float* s_acc = smem;                                  // b accumulators
  float* s_w = s_acc + b;                               // kChunk workloads
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_w + kChunk);
  const int lane = threadIdx.x;

  // Pass 1: the active total and count.
  long long total = 0;
  int n_active = 0;
#pragma unroll 8
  for (int i = lane; i < r; i += kWarp) {
    const int wi = workload[i];
    if (active[i]) {
      total += static_cast<long long>(static_cast<float>(wi));
      ++n_active;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    total += __shfl_xor_sync(kFull, total, off);
    n_active += __shfl_xor_sync(kFull, n_active, off);
  }
  const float fb = static_cast<float>(b);
  const float w_ideal = fmaxf(__ll2float_rn(total) / fb, 1.0f);
  const float n_avg = fmaxf(static_cast<float>(n_active) / fb, 1.0f);
  const float cap = (1.0f + 1.0f / n_avg) * w_ideal;

  for (int j = lane; j < b; j += kWarp) s_acc[j] = 0.0f;
  // The lane's least (key, block), kept current for the dynamic fill.
  unsigned my_key, my_j;
  lane_least(s_acc, b, lane, my_key, my_j);

  // cur and acc_cur (block cur's accumulator, written back to s_acc only
  // when cur changes) are alike in all lanes.
  int cur = 0;
  float acc_cur = 0.0f;
  for (int base = 0; base < r; base += kChunk) {
    const int n = min(kChunk, r - base);
#pragma unroll 8
    for (int i = lane; i < n; i += kWarp) {
      s_w[i] = static_cast<float>(workload[base + i]);
      s_act[i] = active[base + i];
    }
    for (int g = 0; g < n; g += kWarp) {
      const int i = g + lane;
      const bool mine = i < n && s_act[i];
      const float w_mine = mine ? s_w[i] : 0.0f;
      unsigned m = __ballot_sync(kFull, mine);   // slots still to place
      int out = -1;
      if (!m) {
        if (i < n) block_of[base + i] = out;
        continue;
      }
      // One slot a step.
      int k = __ffs(m) - 1;
      m &= m - 1;
      float w = __shfl_sync(kFull, w_mine, k);
      for (;;) {
        // The next step's workload, fetched while this step runs.
        const int k_next = m ? __ffs(m) - 1 : 0;
        const float w_next = __shfl_sync(kFull, w_mine, k_next);
        int tgt;
        if (dynamic) {
          tgt = warp_least(my_key, my_j);
          if (lane == (tgt & (kWarp - 1))) {
            const float a = s_acc[tgt] + w;
            s_acc[tgt] = a;
            if (b <= kWarp) {
              my_key = order_key(a);
            } else {
              lane_least(s_acc, b, lane, my_key, my_j);
            }
          }
        } else if (acc_cur + w <= cap) {
          tgt = cur;
          acc_cur += w;
        } else {
          tgt = defer(s_acc, b, lane, cap, w, cur, acc_cur);
        }
        if (lane == k) out = tgt;
        if (!m) break;
        m &= m - 1;
        k = k_next;
        w = w_next;
      }
      if (i < n) block_of[base + i] = out;
    }
  }
}

// Shared memory one launch takes for b blocks.
int smem_bytes(int b) {
  return static_cast<int>(sizeof(float)) * (b + kChunk) + kChunk;
}

}  // namespace

extern "C" {

int ldu_fill_smem_bytes(int b) { return smem_bytes(b); }

// One launch of one warp on `stream`; returns the CUDA error code of the
// launch (0 on success). workload (r,) int32, active (r,) bool as bytes,
// block_of (r,) int32 out; dynamic != 0 picks the least-loaded fill.
int ldu_fill(const int* workload, const uint8_t* active, int* block_of,
             int r, int b, int dynamic, cudaStream_t stream) {
  const int smem = smem_bytes(b);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ldu_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ldu_fill_kernel<<<1, kWarp, smem, stream>>>(workload, active, block_of, r,
                                              b, dynamic);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
