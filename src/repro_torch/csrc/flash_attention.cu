// Flash attention, forward and backward, on bf16 tensor cores, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes this attention in jnp
// (repro/models/layers.py::flash_attention, an online softmax over chunk
// pairs under lax.scan), and the port's plain version is the same chunk
// loop in PyTorch (models/layers.py::flash_attention_chunked), about a dozen
// eager kernels a chunk pair, float32 scores and a float32 FFMA value
// product. Here one launch computes a layer's forward and two its backward.
//
// Layout (the wrapper's, kernels/flash_attention.py): q (B, S, G, Hq, K),
// k (B, G, T, K), v (B, G, T, Kv), any strides whose last is 1 and whose
// others are multiples of 8 elements; out and the float32 out (B, S, G, Hq,
// Kv), the row log-sum-exp (B, G, Hq, S) in base 2, dq / dk / dv contiguous
// in q's / k's / v's shapes. The query at row i sits at position q_offset +
// i; with `causal` it sees the keys at positions <= its own.
//
// Forward: one CTA of 4 warps a (64-row query tile, b, g, hq), each warp 16
// rows. K / V tiles of 64 keys stream through shared memory by cp.async,
// double-buffered; S = Q K^T is one mma.sync m16n8k16 product in float32;
// the online softmax keeps m, l and the output in float32 registers. The
// probabilities P (float32) are never rounded: each is split exactly into
// three bf16 terms, hi + mid + lo, and P V is three tensor-core
// products into one float32 accumulator, the float32 product up to the
// order of its sums. Tiles that lie wholly above the diagonal are not
// visited: in the chunk loop such a tile adds exp(-1e30 - m) = 0 and scales
// by exp(0) = 1, so the skip changes no bit.
//
// Backward: the dq kernel (a CTA a query tile) first takes D = rowsum(dO *
// O) from the float32 O, writes it for the second kernel, then walks the
// kv tiles: P = exp2(S log2e scale - lse), dP = dO V^T, dS = P (dP - D)
// rounded to the input type, dq += dS K. The dk / dv kernel (a CTA a kv
// tile of one (b, g)) walks the query tiles of every head of the group:
// dv += P^T dO (P split in three, as in the forward), dk += dS^T Q. Each
// output is summed in float32 registers by one CTA and rounded once: no
// atomics, the same bits every run.
//
// What bounds it: the tensor cores. The causal products of a (B 2, S 4096,
// 40 heads, K 96, Kv 64) layer are 2 * 2 * 40 * 4096 * 4097 / 2 * 160 =
// 2.15e11 operations, 0.217 ms at 989 TFLOP/s; the split adds two value
// products, and mma.sync reaches a part of what wgmma would. The bytes
// (q, k, v read once, out written once: 210 MB, 294 MB with the float32
// out, 0.063-0.088 ms at 3.35 TB/s) are not the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// CTAs of 128 query rows (forward, dq) or keys (dk / dv), 8 warps, were
// measured against these: the forward 5 % faster, the backward 4-11 %
// slower (fewer CTAs a SM at dq's and dk / dv's registers).
constexpr int QR = 64;    // query rows a CTA (forward, dq)
constexpr int KR = 64;    // keys a CTA (dk / dv)
constexpr int STEP = 64;  // keys (forward, dq) or query rows (dk / dv) a
                          // step of a CTA's loop
// A warp takes 16 of a CTA's rows: 2 threads a row.
constexpr int threads(int rows) { return rows * 2; }
constexpr int PAD = 8;  // elements after each shared row: ldmatrix reads 8
                        // rows at 16 bytes past 4 banks apart

// -- device instructions --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, or zero where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// All but the newest group of copies have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and gets, of each matrix, row l / 4, columns 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed: lane l gets rows 2 (l % 4) + {0, 1}, column l / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16) b (16 x 8): m16n8k16, row.col.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// -- end device instructions --

__device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi) {
  return (lo & 0xffffu) | (hi << 16);
}

// The input type's conversions: a float to its nearest value, and a float
// split into three values of the type whose sum is the float.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ uint32_t bits_rn(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  // bf16 keeps float32's exponent and the top 8 of its 24 significant
  // bits, so truncating to the top 16 bits takes 8 bits off exactly; the
  // remainder (<= 16 bits) gives 8 more, and what is left (<= 8 bits) is a
  // bf16 as it is. Exact from 2^-100 up; below, the parts reach float32's
  // subnormals (an error under 2^-126, against a row sum of at least 1).
  static __device__ __forceinline__ void split(float x, uint32_t& h,
                                               uint32_t& m, uint32_t& l) {
    const uint32_t hb = __float_as_uint(x) & 0xffff0000u;
    const float r1 = x - __uint_as_float(hb);
    const uint32_t mb = __float_as_uint(r1) & 0xffff0000u;
    const float r2 = r1 - __uint_as_float(mb);
    h = hb >> 16;
    m = mb >> 16;
    l = __float_as_uint(r2) >> 16;
  }
};


// `rows` rows of `COLS` elements from `src` (row stride `stride`), starting
// at row `row0`, into shared `dst` (row stride COLS + PAD); rows at or past
// `nrows` become zeros.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int CPR = COLS / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += blockDim.x) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = row0 + r < nrows;
    const T* g = ok ? src + (row0 + r) * stride + cc * 8 : src;
    cp_async16(dst + r * (COLS + PAD) + cc * 8, g, ok);
  }
}

// acc (16 x N) += A B^T: A the 16 rows of shared `a` from `a_row0`, B the N
// rows of shared `b`, both K long (row strides lda, ldb).
template <typename T, int K, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const T* a,
                                        int lda, int a_row0, const T* b,
                                        int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (a_row0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * ldb +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      Mma<T>::run(acc[2 * nb], af, bf[0], bf[1]);
      Mma<T>::run(acc[2 * nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += sum over the NA terms of A_i B: each A_i (16 x K) in
// registers as K / 16 fragments, B (K x N) the rows of shared `b`.
template <typename T, int K, int N, int NA>
__device__ __forceinline__ void mma_ab(float (&acc)[N / 8][4],
                                       const uint32_t (&a)[NA][K / 16][4],
                                       const T* b, int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                        nb * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        Mma<T>::run(acc[2 * nb], a[i][kk], bf[0], bf[1]);
        Mma<T>::run(acc[2 * nb + 1], a[i][kk], bf[2], bf[3]);
      }
    }
  }
}

// An accumulator (16 x N, float32) as the A fragments of the next product,
// each value split into three (P) ...
template <typename T, int N>
__device__ __forceinline__ void split_fragments(
    const float (&c)[N / 8][4], uint32_t (&a)[3][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // a0: (row, 2t) of block 2kk; a1: row + 8; a2, a3: block 2kk + 1.
      const int blk = 2 * kk + (r >> 1), col = (r & 1) * 2;
      uint32_t h0, m0, l0, h1, m1, l1;
      Elem<T>::split(c[blk][col], h0, m0, l0);
      Elem<T>::split(c[blk][col + 1], h1, m1, l1);
      a[0][kk][r] = pair(h0, h1);
      a[1][kk][r] = pair(m0, m1);
      a[2][kk][r] = pair(l0, l1);
    }
  }
}

// ... or rounded to the input type (dS).
template <typename T, int N>
__device__ __forceinline__ void round_fragments(const float (&c)[N / 8][4],
                                                uint32_t (&a)[1][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int blk = 2 * kk + (r >> 1), col = (r & 1) * 2;
      a[0][kk][r] = pair(Elem<T>::bits_rn(c[blk][col]),
                         Elem<T>::bits_rn(c[blk][col + 1]));
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;           // forward: (B, S, G, Hq, Kv) in q's type
  float* out32;        // forward: the same in float32, or null
  float* lse;          // (B, G, Hq, S): log2 of each row's sum of exp2
  const void* dout;    // backward: (B, S, G, Hq, Kv), contiguous
  const float* o32;    // backward: the forward's float32 out
  float* dsum;         // backward: D = rowsum(dO * O), (B, G, Hq, S)
  void* dq;            // backward outputs, contiguous
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sg, q_sh;
  long long k_sb, k_sg, k_st;
  long long v_sb, v_sg, v_st;
  int b, s, t, g, hq;
  int causal, q_offset;
  float scale_log2;    // scale * log2(e): scores in base 2
  float scale;
};

// Keys a query tile starting at row m0 visits: the tiles up to the one that
// holds its last row's position (causal), else all.
__device__ __forceinline__ int kv_tiles(const Params& p, int m0) {
  const int n = (p.t + STEP - 1) / STEP;
  return p.causal ? min(n, (p.q_offset + m0 + QR - 1) / STEP + 1) : n;
}

// A tile of keys from key0 needs a mask for the rows from m0: keys past t,
// or (causal) a key past the first row's position.
__device__ __forceinline__ bool kv_edge(const Params& p, int key0, int m0) {
  return key0 + STEP > p.t ||
         (p.causal && key0 + STEP - 1 > p.q_offset + m0);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(threads(QR))
    flash_fwd_kernel(const Params p) {
  constexpr int LDK = D + PAD, LDV = DV + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + QR * LDK;
  T* sV = sK + 2 * STEP * LDK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The longest rows (most kv tiles under the causal mask) go first.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * QR;
  const int h = blockIdx.y % p.hq;
  const int g = (blockIdx.y / p.hq) % p.g;
  const int b = blockIdx.y / (p.hq * p.g);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + g * p.q_sg +
               h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sg;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sg;
  const int n_tiles = kv_tiles(p, m0);

  load_rows<T, QR, D>(sQ, q, p.q_ss, m0, p.s);
  load_rows<T, STEP, D>(sK, k, p.k_st, 0, p.t);
  load_rows<T, STEP, DV>(sV, v, p.v_st, 0, p.t);
  cp_async_commit();

  float o[DV / 8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int r_lo = warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_rows<T, STEP, D>(sK + nb * STEP * LDK, k, p.k_st, (j + 1) * STEP, p.t);
      load_rows<T, STEP, DV>(sV + nb * STEP * LDV, v, p.v_st, (j + 1) * STEP, p.t);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const T* cK = sK + (j & 1) * STEP * LDK;
    const T* cV = sV + (j & 1) * STEP * LDV;

    float s[STEP / 8][4];
    zero(s);
    mma_abt<T, D, STEP>(s, sQ, LDK, warp * 16, cK, LDK, lane);

    const int key0 = j * STEP;
    const bool edge = kv_edge(p, key0, m0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nb = 0; nb < STEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * p.scale_log2;
        if (edge) {
          const int key = key0 + nb * 8 + (lane & 3) * 2 + (e & 1);
          const int pos = p.q_offset + m0 + r_lo + (e >> 1) * 8;
          if (key >= p.t || (p.causal && key > pos)) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // A row that has seen only masked keys keeps zeros (no -inf - -inf).
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m_run[i] - base[i]);
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int nb = 0; nb < STEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nb][e] - base[e >> 1]);
        s[nb][e] = pe;
        rs[e >> 1] += pe;
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nb = 0; nb < DV / 8; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
    }
    uint32_t pa[3][STEP / 16][4];
    split_fragments<T, STEP>(s, pa);
    mma_ab<T, STEP, DV, 3>(o, pa, cV, LDV, lane);
    __syncthreads();  // the buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + r_lo + i * 8;
    if (row >= p.s) continue;
    const float den = fmaxf(l, 1e-30f);
    const long long base_o =
        ((((long long)b * p.s + row) * p.g + g) * p.hq + h) * DV;
    T* out = static_cast<T*>(p.out) + base_o;
#pragma unroll
    for (int nb = 0; nb < DV / 8; ++nb) {
      const int col = nb * 8 + (lane & 3) * 2;
      const float x0 = o[nb][2 * i] / den, x1 = o[nb][2 * i + 1] / den;
      *reinterpret_cast<uint32_t*>(out + col) =
          pair(Elem<T>::bits_rn(x0), Elem<T>::bits_rn(x1));
      if (p.out32 != nullptr)
        *reinterpret_cast<float2*>(p.out32 + base_o + col) =
            make_float2(x0, x1);
    }
    if ((lane & 3) == 0)
      p.lse[(((long long)b * p.g + g) * p.hq + h) * p.s + row] =
          m_run[i] + log2f(l);
  }
}

// dq for a query tile; first D = rowsum(dO * O32) of its rows, into dsum.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(threads(QR))
    flash_bwd_dq_kernel(const Params p) {
  constexpr int LDK = D + PAD, LDV = DV + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + QR * LDK;
  T* sK = sdO + QR * LDV;
  T* sV = sK + 2 * STEP * LDK;
  float* sL = reinterpret_cast<float*>(sV + 2 * STEP * LDV);
  float* sD = sL + QR;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * QR;
  const int h = blockIdx.y % p.hq;
  const int g = (blockIdx.y / p.hq) % p.g;
  const int b = blockIdx.y / (p.hq * p.g);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + g * p.q_sg +
               h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sg;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sg;
  const long long o_ss = (long long)p.g * p.hq * DV;  // row stride of dO, O
  const long long o_base = (((long long)b * p.s * p.g + g) * p.hq + h) * DV;
  const T* dout = static_cast<const T*>(p.dout) + o_base;
  const float* o32 = p.o32 + o_base;
  const long long l_base = (((long long)b * p.g + g) * p.hq + h) * p.s;
  const int n_tiles = kv_tiles(p, m0);

  load_rows<T, QR, D>(sQ, q, p.q_ss, m0, p.s);
  load_rows<T, QR, DV>(sdO, dout, o_ss, m0, p.s);
  load_rows<T, STEP, D>(sK, k, p.k_st, 0, p.t);
  load_rows<T, STEP, DV>(sV, v, p.v_st, 0, p.t);
  cp_async_commit();

  // D, a warp a row, from global memory while the tiles load.
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int row = m0 + r;
    float acc = 0.f;
    if (row < p.s)
      for (int c = lane; c < DV; c += 32)
        acc += Elem<T>::to_float(dout[row * o_ss + c]) * o32[row * o_ss + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = row < p.s ? p.lse[l_base + row] : 0.f;
      if (row < p.s) p.dsum[l_base + row] = acc;
    }
  }
  __syncthreads();
  const int r_lo = warp * 16 + (lane >> 2);
  const float lse_r[2] = {sL[r_lo], sL[r_lo + 8]};
  const float d_r[2] = {sD[r_lo], sD[r_lo + 8]};

  float dq[D / 8][4];
  zero(dq);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_rows<T, STEP, D>(sK + nb * STEP * LDK, k, p.k_st, (j + 1) * STEP, p.t);
      load_rows<T, STEP, DV>(sV + nb * STEP * LDV, v, p.v_st, (j + 1) * STEP, p.t);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const T* cK = sK + (j & 1) * STEP * LDK;
    const T* cV = sV + (j & 1) * STEP * LDV;

    float s[STEP / 8][4], dp[STEP / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, D, STEP>(s, sQ, LDK, warp * 16, cK, LDK, lane);
    mma_abt<T, DV, STEP>(dp, sdO, LDV, warp * 16, cV, LDV, lane);

    const int key0 = j * STEP;
    const bool edge = kv_edge(p, key0, m0);
#pragma unroll
    for (int nb = 0; nb < STEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * p.scale_log2;
        if (edge) {
          const int key = key0 + nb * 8 + (lane & 3) * 2 + (e & 1);
          const int pos = p.q_offset + m0 + r_lo + (e >> 1) * 8;
          if (key >= p.t || (p.causal && key > pos)) x = -INFINITY;
        }
        const float pe = exp2f(x - lse_r[e >> 1]);
        s[nb][e] = pe * (dp[nb][e] - d_r[e >> 1]);
      }
    }
    uint32_t da[1][STEP / 16][4];
    round_fragments<T, STEP>(s, da);
    mma_ab<T, STEP, D, 1>(dq, da, cK, LDK, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + r_lo + i * 8;
    if (row >= p.s) continue;
    T* out = static_cast<T*>(p.dq) +
             ((((long long)b * p.s + row) * p.g + g) * p.hq + h) * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = nb * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(out + col) =
          pair(Elem<T>::bits_rn(dq[nb][2 * i] * p.scale),
               Elem<T>::bits_rn(dq[nb][2 * i + 1] * p.scale));
    }
  }
}

// dk and dv for a kv tile of one (b, g), over every head of the group.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(threads(KR))
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int LDK = D + PAD, LDV = DV + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + KR * LDK;
  T* sQ = sV + KR * LDV;
  T* sdO = sQ + 2 * STEP * LDK;
  float* sL = reinterpret_cast<float*>(sdO + 2 * STEP * LDV);
  float* sD = sL + 2 * STEP;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The first keys meet the most query tiles under the causal mask.
  const int n0 = blockIdx.x * KR;
  const int g = blockIdx.y % p.g;
  const int b = blockIdx.y / p.g;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sg;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sg;
  const long long o_ss = (long long)p.g * p.hq * DV;
  const int n_m = (p.s + STEP - 1) / STEP;
  int i0 = 0;  // the first query tile with a row at or past key n0
  if (p.causal) {
    const int num = n0 - p.q_offset - (STEP - 1);
    i0 = num <= 0 ? 0 : (num + STEP - 1) / STEP;
  }
  const int per_head = max(n_m - i0, 0);
  const int iters = per_head * p.hq;

  // Query tile number `it` (head it / per_head) into buffer `buf`.
  auto load_q = [&](int it, int buf) {
    const int h = it / per_head, m0 = (i0 + it % per_head) * STEP;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + g * p.q_sg +
                 h * p.q_sh;
    const long long o_base = (((long long)b * p.s * p.g + g) * p.hq + h) * DV;
    load_rows<T, STEP, D>(sQ + buf * STEP * LDK, q, p.q_ss, m0, p.s);
    load_rows<T, STEP, DV>(sdO + buf * STEP * LDV,
                         static_cast<const T*>(p.dout) + o_base, o_ss, m0,
                         p.s);
    // The step's lse and D: a thread each (KR >= STEP, so 2 KR threads
    // cover both).
    if (threadIdx.x < 2 * STEP) {
      const long long l_base = (((long long)b * p.g + g) * p.hq + h) * p.s;
      const int r = threadIdx.x & (STEP - 1);
      const bool ok = m0 + r < p.s;
      const float* src = (threadIdx.x < STEP ? p.lse : p.dsum) + l_base +
                         (ok ? m0 + r : 0);
      cp_async4((threadIdx.x < STEP ? sL : sD) + buf * STEP + r, src, ok);
    }
  };

  load_rows<T, KR, D>(sK, k, p.k_st, n0, p.t);
  load_rows<T, KR, DV>(sV, v, p.v_st, n0, p.t);
  if (iters > 0) load_q(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[DV / 8][4];
  zero(dk);
  zero(dv);
  const int key_lo = n0 + warp * 16 + (lane >> 2);  // keys key_lo, + 8
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int buf = it & 1;
    const int m0 = (i0 + it % per_head) * STEP;
    const T* cQ = sQ + buf * STEP * LDK;
    const T* cdO = sdO + buf * STEP * LDV;
    const float* cL = sL + buf * STEP;
    const float* cD = sD + buf * STEP;

    // S^T and dP^T: rows the warp's 16 keys, columns the 64 query rows.
    float s[STEP / 8][4], dp[STEP / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, D, STEP>(s, sK, LDK, warp * 16, cQ, LDK, lane);
    mma_abt<T, DV, STEP>(dp, sV, LDV, warp * 16, cdO, LDV, lane);

    const bool edge = m0 + STEP > p.s || n0 + KR > p.t ||
                      (p.causal && n0 + KR - 1 > p.q_offset + m0);
#pragma unroll
    for (int nb = 0; nb < STEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + (lane & 3) * 2 + (e & 1);
        float x = s[nb][e] * p.scale_log2;
        if (edge) {
          const int key = key_lo + (e >> 1) * 8, row = m0 + col;
          if (row >= p.s || key >= p.t ||
              (p.causal && key > p.q_offset + row))
            x = -INFINITY;
        }
        const float pe = exp2f(x - cL[col]);
        s[nb][e] = pe;
        dp[nb][e] = pe * (dp[nb][e] - cD[col]);
      }
    }
    uint32_t pa[3][STEP / 16][4];
    split_fragments<T, STEP>(s, pa);
    mma_ab<T, STEP, DV, 3>(dv, pa, cdO, LDV, lane);
    uint32_t da[1][STEP / 16][4];
    round_fragments<T, STEP>(dp, da);
    mma_ab<T, STEP, D, 1>(dk, da, cQ, LDK, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + i * 8;
    if (key >= p.t) continue;
    const long long row = ((long long)b * p.g + g) * p.t + key;
    T* ok_ = static_cast<T*>(p.dk) + row * D;
    T* ov_ = static_cast<T*>(p.dv) + row * DV;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = nb * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(ok_ + col) =
          pair(Elem<T>::bits_rn(dk[nb][2 * i] * p.scale),
               Elem<T>::bits_rn(dk[nb][2 * i + 1] * p.scale));
    }
#pragma unroll
    for (int nb = 0; nb < DV / 8; ++nb) {
      const int col = nb * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(ov_ + col) =
          pair(Elem<T>::bits_rn(dv[nb][2 * i]),
               Elem<T>::bits_rn(dv[nb][2 * i + 1]));
    }
  }
}

// Shared bytes of each kernel (2-byte elements).
constexpr int fwd_smem(int d, int dv) {
  return (QR * (d + PAD) + 2 * STEP * (d + PAD) + 2 * STEP * (dv + PAD)) * 2;
}
constexpr int dq_smem(int d, int dv) {
  return (QR * (d + PAD) + QR * (dv + PAD) + 2 * STEP * (d + PAD) +
          2 * STEP * (dv + PAD)) * 2 + 2 * QR * 4;
}
constexpr int dkv_smem(int d, int dv) {
  return (KR * (d + PAD) + KR * (dv + PAD) + 2 * STEP * (d + PAD) +
          2 * STEP * (dv + PAD)) * 2 + 4 * STEP * 4;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int block, int smem, const Params& p,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int DV>
int run(int backward, const Params& p, cudaStream_t stream) {
  const dim3 q_grid((p.s + QR - 1) / QR, p.b * p.g * p.hq);
  if (!backward)
    return launch(flash_fwd_kernel<T, D, DV>, q_grid, threads(QR),
                  fwd_smem(D, DV), p, stream);
  const int err = launch(flash_bwd_dq_kernel<T, D, DV>, q_grid, threads(QR),
                         dq_smem(D, DV), p, stream);
  if (err != 0) return err;
  const dim3 kv_grid((p.t + KR - 1) / KR, p.b * p.g);
  return launch(flash_bwd_dkv_kernel<T, D, DV>, kv_grid, threads(KR),
                dkv_smem(D, DV), p, stream);
}

// The compiled widths, one line each: MiniCPM3's MLA (96, 64), the GQA
// heads of 128 (yi-9b, starcoder2-7b, moonshot) and of 64 (whisper's
// encoder). The kernels keep the input type as a template parameter; bf16
// is the one compiled.
int dispatch(int d, int dv, int backward, const Params& p,
             cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (d == 96 && dv == 64) return run<T, 96, 64>(backward, p, stream);
  if (d == 128 && dv == 128) return run<T, 128, 128>(backward, p, stream);
  if (d == 64 && dv == 64) return run<T, 64, 64>(backward, p, stream);
  return -1;
}

Params make_params(const void* q, const void* k, const void* v,
                   const long long* strides, int b, int s, int t, int g,
                   int hq, int causal, int q_offset, float scale_log2,
                   float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sg = strides[2];
  p.q_sh = strides[3];
  p.k_sb = strides[4];
  p.k_sg = strides[5];
  p.k_st = strides[6];
  p.v_sb = strides[7];
  p.v_sg = strides[8];
  p.v_st = strides[9];
  p.b = b;
  p.s = s;
  p.t = t;
  p.g = g;
  p.hq = hq;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale_log2 = scale_log2;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Shared bytes a CTA of kernel `which` (0 forward, 1 dq, 2 dk / dv) takes.
int flash_attention_smem_bytes(int which, int d, int dv) {
  return which == 0 ? fwd_smem(d, dv) : which == 1 ? dq_smem(d, dv)
                                                   : dkv_smem(d, dv);
}

// bf16 tensors; strides: q's (b, s, g, hq), k's (b, g, t), v's (b, g, t)
// in elements. out32 may be null. Returns the CUDA error of the launch (0
// on success), -1 for a width not compiled.
int flash_attention_fwd(int d, int dv, const void* q, const void* k,
                        const void* v, void* out, float* out32, float* lse,
                        const long long* strides, int b, int s, int t, int g,
                        int hq, int causal, int q_offset, float scale_log2,
                        float scale, cudaStream_t stream) {
  Params p = make_params(q, k, v, strides, b, s, t, g, hq, causal, q_offset,
                         scale_log2, scale);
  p.out = out;
  p.out32 = out32;
  p.lse = lse;
  return dispatch(d, dv, 0, p, stream);
}

// The two backward launches: dq (and dsum), then dk and dv. dout and o32
// are contiguous (b, s, g, hq, dv); dq, dk, dv contiguous.
int flash_attention_bwd(int d, int dv, const void* q, const void* k,
                        const void* v, const void* dout, const float* o32,
                        const float* lse, float* dsum, void* dq, void* dk,
                        void* dvv,
                        const long long* strides, int b, int s, int t, int g,
                        int hq, int causal, int q_offset, float scale_log2,
                        float scale, cudaStream_t stream) {
  Params p = make_params(q, k, v, strides, b, s, t, g, hq, causal, q_offset,
                         scale_log2, scale);
  p.dout = dout;
  p.o32 = o32;
  p.lse = const_cast<float*>(lse);
  p.dsum = dsum;
  p.dq = dq;
  p.dk = dk;
  p.dv = dvv;
  return dispatch(d, dv, 1, p, stream);
}

}  // extern "C"
