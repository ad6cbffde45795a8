// Per-Gaussian preprocess geometry for Hopper (sm_90a).
//
// Replaces repro/kernels/preprocess.py::_preproc_kernel (the paper's CCU,
// reached through preprocess_geom_pallas). Per Gaussian: camera transform
// and projection, quaternion -> rotation, 3D covariance, the EWA Jacobian
// with tx/ty clamped to the widened frustum, 2D covariance + dilation,
// conic, 2x2 eigen-decomposition, radius3, the TAIT radii (eq. 4) and the
// tight-bbox half extents (eq. 6), and validity: every field of
// kernels/preprocess.py::PreprocessGeom, as preprocess_geom_torch computes
// them, operation for operation.
//
// What bounds it: bytes. Each Gaussian reads 44 B and writes 73 B for
// some 200 float operations, below the card's ~20 flop/B fp32 balance
// point, and the whole call is short (131,072 Gaussians move 15.3 MB,
// 4.6 us at 3.35 TB/s), so memory parallelism and the host's launch cost
// decide. The design:
//
//   - one thread per Gaussian, CTAs of 128 threads capped at 64 registers
//     (it takes 46) so that at least 8 CTAs (32 warps) fit a SM: 131,072
//     Gaussians are 1,024 CTAs, one wave over 132 SMs;
//   - each thread loads its Gaussian's fields and stores its outputs
//     itself: a warp's accesses to one field cover one contiguous span
//     (the 2-wide fields as 8-byte stores), so every access is coalesced.
//     Staging the CTA's inputs and outputs in shared memory to move them
//     as 16-byte accesses was measured slower on the card: 0.0110 ms with
//     both staged and 0.0095 ms with only the inputs staged, against
//     0.0085 ms for this design (PERF.md);
//   - the outputs are one buffer the wrapper allocates once, carved into
//     the 11 fields at offsets of a stride S = round_up(N, 4) words
//     (output_layout in kernels/preprocess.py), so the host makes one
//     allocation, not eleven;
//   - the intrinsics and scalars arrive by value (PreprocessParams); the
//     camera rows stay on the device (reading them on the host would put
//     a device-to-host sync before every frame's preprocess): every
//     thread reads the same 12 words, one cached broadcast a warp;
//   - no shared memory, so the launch needs no cudaFuncSetAttribute call.
//
// Built with -fmad=false so that the arithmetic rounds as the plain
// PyTorch version's separate operations do (the camera transform's fma
// chain is explicit, as its matmul rounds); expf, logf, sqrtf and the
// divisions are the accurate ones.

#include <cuda_runtime.h>
#include <math.h>

// The kernel's scalars, passed by value (kernels/preprocess.py::Params).
struct PreprocessParams {
  float fx, fy, cx, cy, width, height;
  float lim_x, lim_y;  // frustum_margin * width / (2 fx), ... height / (2 fy)
  float near, dilation, alpha_thr;
  int n;
};

namespace {

constexpr int kBlock = 128;  // Gaussians (threads) a CTA
constexpr int kMinCtas = 8;  // 64 registers a thread
// Output fields in buffer order: mean2d, cov2d, conic, depth, radius3,
// eigvals, minor_axis, r_major, r_minor, tight_half_wh (float32), then
// valid (bytes). Field f takes field_width(f) words a Gaussian and starts
// at field_offset(f) times the stride S; valid starts at 18 S.
constexpr int kFields = 10;
constexpr int kFloatWords = 18;

__host__ __device__ constexpr int field_width(int f) {
  return (f == 1 || f == 2)                        ? 3
         : (f == 0 || f == 5 || f == 6 || f == 9) ? 2
                                                   : 1;
}

__host__ __device__ constexpr int field_offset(int f) {
  return f == 0 ? 0 : field_offset(f - 1) + field_width(f - 1);
}

// Field F's words. The offset is evaluated at compile time: nvcc does
// not inline the recursion above, and a call of it before each store
// made the kernel 5x slower (PERF.md).
template <int F>
__device__ __forceinline__ float* field(float* out, size_t stride) {
  constexpr int kOffset = field_offset(F);
  return out + kOffset * stride;
}

static_assert(field_offset(kFields - 1) + field_width(kFields - 1) ==
                  kFloatWords,
              "the float fields fill 18 words a Gaussian");

__global__ void __launch_bounds__(kBlock, kMinCtas) preprocess_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ opacity,
    const float* __restrict__ w2c, float* __restrict__ out,
    PreprocessParams p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const size_t g = i;
  const float mx = means[3 * g], my = means[3 * g + 1],
              mz = means[3 * g + 2];
  const float ls0 = log_scales[3 * g], ls1 = log_scales[3 * g + 1],
              ls2 = log_scales[3 * g + 2];
  const float4 q = make_float4(quats[4 * g], quats[4 * g + 1],
                               quats[4 * g + 2], quats[4 * g + 3]);
  const float opac = opacity[g];
  // Rows 0-2 of the (4, 4) world-to-camera matrix.
  const float c00 = w2c[0], c01 = w2c[1], c02 = w2c[2], t0 = w2c[3];
  const float c10 = w2c[4], c11 = w2c[5], c12 = w2c[6], t1 = w2c[7];
  const float c20 = w2c[8], c21 = w2c[9], c22 = w2c[10], t2 = w2c[11];

  // Camera transform and projection. The plain version's means @ R^T is
  // a matmul, which rounds each row as this fma chain does on the card
  // (mean2d and depth then agree bit for bit; separate operations
  // differ in up to 12 % of them, PERF.md); + t is a separate add there
  // too.
  const float pcx = fmaf(c02, mz, fmaf(c01, my, c00 * mx)) + t0;
  const float pcy = fmaf(c12, mz, fmaf(c11, my, c10 * mx)) + t1;
  const float z = fmaf(c22, mz, fmaf(c21, my, c20 * mx)) + t2;
  const float safe_z = fmaxf(z, p.near);
  const float u = p.fx * pcx / safe_z + p.cx;
  const float v = p.fy * pcy / safe_z + p.cy;

  // Quaternion -> rotation (normalised as quat_to_rotmat does), then
  // M = R diag(s) and the world covariance M M^T.
  const float qn = sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w) +
                   1e-12f;
  const float qw = q.x / qn, qx = q.y / qn, qy = q.z / qn, qz = q.w / qn;
  const float s0 = expf(ls0), s1 = expf(ls1), s2 = expf(ls2);
  const float m00 = (1.0f - 2.0f * (qy * qy + qz * qz)) * s0;
  const float m01 = (2.0f * (qx * qy - qw * qz)) * s1;
  const float m02 = (2.0f * (qx * qz + qw * qy)) * s2;
  const float m10 = (2.0f * (qx * qy + qw * qz)) * s0;
  const float m11 = (1.0f - 2.0f * (qx * qx + qz * qz)) * s1;
  const float m12 = (2.0f * (qy * qz - qw * qx)) * s2;
  const float m20 = (2.0f * (qx * qz - qw * qy)) * s0;
  const float m21 = (2.0f * (qy * qz + qw * qx)) * s1;
  const float m22 = (1.0f - 2.0f * (qx * qx + qy * qy)) * s2;
  const float v00 = m00 * m00 + m01 * m01 + m02 * m02;
  const float v01 = m00 * m10 + m01 * m11 + m02 * m12;
  const float v02 = m00 * m20 + m01 * m21 + m02 * m22;
  const float v11 = m10 * m10 + m11 * m11 + m12 * m12;
  const float v12 = m10 * m20 + m11 * m21 + m12 * m22;
  const float v22 = m20 * m20 + m21 * m21 + m22 * m22;

  // EWA Jacobian with tx/ty clamped to the widened frustum.
  const float tx = fminf(fmaxf(pcx / safe_z, -p.lim_x), p.lim_x) * safe_z;
  const float ty = fminf(fmaxf(pcy / safe_z, -p.lim_y), p.lim_y) * safe_z;
  const float inv_z = 1.0f / safe_z;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = p.fx * inv_z;
  const float j02 = -p.fx * tx * inv_z2;
  const float j11 = p.fy * inv_z;
  const float j12 = -p.fy * ty * inv_z2;
  // W = J @ Rcam (2x3), then cov2d = (W V) W^T.
  const float w00 = j00 * c00 + j02 * c20;
  const float w01 = j00 * c01 + j02 * c21;
  const float w02 = j00 * c02 + j02 * c22;
  const float w10 = j11 * c10 + j12 * c20;
  const float w11 = j11 * c11 + j12 * c21;
  const float w12 = j11 * c12 + j12 * c22;
  const float p00 = w00 * v00 + w01 * v01 + w02 * v02;
  const float p01 = w00 * v01 + w01 * v11 + w02 * v12;
  const float p02 = w00 * v02 + w01 * v12 + w02 * v22;
  const float p10 = w10 * v00 + w11 * v01 + w12 * v02;
  const float p11 = w10 * v01 + w11 * v11 + w12 * v12;
  const float p12 = w10 * v02 + w11 * v12 + w12 * v22;
  const float a = p00 * w00 + p01 * w01 + p02 * w02 + p.dilation;
  const float b = p00 * w10 + p01 * w11 + p02 * w12;
  const float c = p10 * w10 + p11 * w11 + p12 * w12 + p.dilation;

  const float det = a * c - b * b;
  const float det_safe = fmaxf(det, 1e-12f);

  // 2x2 eigen-decomposition; minor axis = eigenvector of lam2.
  const float mid = 0.5f * (a + c);
  const float half_diff = 0.5f * (a - c);
  const float disc = sqrtf(fmaxf(half_diff * half_diff + b * b, 1e-12f));
  const float lam1 = mid + disc;
  const float lam2 = fmaxf(mid - disc, 1e-8f);
  const bool big_b = fabsf(b) > 1e-12f;
  const float ex = big_b ? b : (a <= c ? 1.0f : 0.0f);
  const float ey = big_b ? lam2 - a : (a > c ? 1.0f : 0.0f);
  const float en = sqrtf(ex * ex + ey * ey) + 1e-12f;

  const float radius3 = ceilf(3.0f * sqrtf(lam1));
  // eq. (4) radii and eq. (6) tight-bbox half extents.
  const float log_ratio = logf(fmaxf(opac / p.alpha_thr, 1.0f + 1e-6f));
  const float r_major = sqrtf(2.0f * log_ratio * lam1);
  const float r_minor = sqrtf(2.0f * log_ratio * lam2);
  const float half_w = sqrtf(fmaxf(a / lam1, 0.0f)) * r_major;
  const float half_h = sqrtf(fmaxf(c / lam1, 0.0f)) * r_major;

  const bool on_screen = (u + radius3 > 0.0f) && (u - radius3 < p.width) &&
                         (v + radius3 > 0.0f) && (v - radius3 < p.height);
  const bool valid = (z > p.near) && (opac > p.alpha_thr) && on_screen &&
                     (det > 1e-12f);

  // Component c of field f of Gaussian g at word S * field_offset(f) +
  // field_width(f) * g + c; valid's byte g after kFloatWords * S words.
  const size_t stride = (static_cast<size_t>(p.n) + 3) & ~size_t{3};
  reinterpret_cast<float2*>(field<0>(out, stride))[g] = make_float2(u, v);
  float* cov2d = field<1>(out, stride);
  cov2d[3 * g] = a;
  cov2d[3 * g + 1] = b;
  cov2d[3 * g + 2] = c;
  float* conic = field<2>(out, stride);
  conic[3 * g] = c / det_safe;
  conic[3 * g + 1] = -b / det_safe;
  conic[3 * g + 2] = a / det_safe;
  field<3>(out, stride)[g] = z;
  field<4>(out, stride)[g] = radius3;
  reinterpret_cast<float2*>(field<5>(out, stride))[g] =
      make_float2(lam1, lam2);
  reinterpret_cast<float2*>(field<6>(out, stride))[g] =
      make_float2(ex / en, ey / en);
  field<7>(out, stride)[g] = r_major;
  field<8>(out, stride)[g] = r_minor;
  reinterpret_cast<float2*>(field<9>(out, stride))[g] =
      make_float2(half_w, half_h);
  reinterpret_cast<unsigned char*>(out + kFloatWords * stride)[g] =
      valid ? 1 : 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes). means (N, 3), log_scales
// (N, 3), quats (N, 4) (w, x, y, z), opacity (N,) and w2c (4, 4),
// contiguous float32 on the device; ``out`` is the wrapper's buffer of
// 18 S + S / 4 words, S = round_up(N, 4), 8-byte aligned. Returns
// cudaGetLastError().
extern "C" int preprocess_geom(const float* means, const float* log_scales,
                               const float* quats, const float* opacity,
                               const float* w2c, float* out,
                               PreprocessParams p, void* stream) {
  if (p.n > 0) {
    const int grid = (p.n + kBlock - 1) / kBlock;
    preprocess_kernel<<<grid, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        means, log_scales, quats, opacity, w2c, out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
