"""Preprocess geometry: a Triton kernel and its plain PyTorch version.

Replaces ``repro/kernels/preprocess.py::_preproc_kernel`` (the paper's
CCU, reached through ``preprocess_geom_pallas``). Per Gaussian: camera
transform and projection, quaternion -> rotation, 3D covariance, the EWA
Jacobian with tx/ty clamped to the frustum, 2D covariance + dilation,
conic, 2x2 eigen-decomposition, ``radius3``, the TAIT radii (eq. 4) and
the tight-bbox half extents (eq. 6), and validity. It emits every
geometry field ``ProjectedGaussians`` carries (a superset of the Pallas
kernel's outputs); SH colour and the sigmoid opacity stay in torch
(``core/projection.py``).

What bounds it on an H100: bytes. Each Gaussian reads 44 B and writes
73 B for some 200 float operations (a few of them sqrt/exp/log), below
the card's ~20 flop/B fp32 balance point. The design is one pass,
one program per block of ``BLOCK`` Gaussians, every intermediate in
registers; the camera (12 floats + intrinsics) is read as scalars.

``preprocess_geom`` is the wrapper: CPU tensors take the plain version
(the ported ``projection.preprocess`` math), CUDA tensors launch the
Triton kernel, and ``preprocess_geom.launches`` counts those launches.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.gaussians import covariances_from

# Opacity threshold below which a Gaussian does not contribute (1/255).
ALPHA_THRESHOLD = 1.0 / 255.0
# Low-pass dilation added to the projected covariance diagonal.
COV2D_DILATION = 0.3
BLOCK = 256


class PreprocessGeom(NamedTuple):
    """Per-Gaussian screen-space geometry (N rows; see ProjectedGaussians)."""

    mean2d: torch.Tensor         # (N, 2)
    cov2d: torch.Tensor          # (N, 3) upper-tri (a, b, c)
    conic: torch.Tensor          # (N, 3)
    depth: torch.Tensor          # (N,)
    radius3: torch.Tensor        # (N,)
    eigvals: torch.Tensor        # (N, 2)
    minor_axis: torch.Tensor     # (N, 2)
    r_major: torch.Tensor        # (N,)
    r_minor: torch.Tensor        # (N,)
    tight_half_wh: torch.Tensor  # (N, 2)
    valid: torch.Tensor          # (N,) bool


def pallas_layout(g: PreprocessGeom):
    """(mean2d, conic, depth, aux, minor_axis) as the Pallas kernel emits
    them, aux (N, 6) = [radius3, r_major, r_minor, half_w, half_h, valid]."""
    aux = torch.stack([g.radius3, g.r_major, g.r_minor,
                       g.tight_half_wh[:, 0], g.tight_half_wh[:, 1],
                       g.valid.to(g.depth.dtype)], dim=-1)
    return g.mean2d, g.conic, g.depth, aux, g.minor_axis


def _eig2x2(a, b, c):
    """Eigen-decomposition of symmetric [[a, b], [b, c]].

    Returns (lam1, lam2, minor_axis) with lam1 >= lam2 and minor_axis the
    unit eigenvector belonging to lam2.
    """
    mid = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    disc = torch.sqrt(torch.clamp_min(half_diff * half_diff + b * b, 1e-12))
    lam1 = mid + disc
    lam2 = torch.clamp_min(mid - disc, 1e-8)
    big_b = b.abs() > 1e-12
    ex = torch.where(big_b, b, (a <= c).to(a.dtype))
    ey = torch.where(big_b, lam2 - a, (a > c).to(a.dtype))
    norm = torch.sqrt(ex * ex + ey * ey) + 1e-12
    return lam1, lam2, torch.stack([ex / norm, ey / norm], dim=-1)


def preprocess_geom_torch(means, log_scales, quats, opacity, w2c,
                          intrin: Sequence[float], *, near: float = 0.05,
                          frustum_margin: float = 1.3,
                          dilation: float = COV2D_DILATION
                          ) -> PreprocessGeom:
    """Plain version: the ``repro/core/projection.py::preprocess`` math.

    intrin = (fx, fy, cx, cy, width, height) as Python numbers.
    """
    fx, fy, cx, cy, width, height = (float(v) for v in intrin)
    rot, t = w2c[:3, :3], w2c[:3, 3]
    p_cam = means @ rot.T + t                             # (N, 3)
    z = p_cam[..., 2]
    safe_z = torch.clamp_min(z, near)

    u = fx * p_cam[..., 0] / safe_z + cx
    v = fy * p_cam[..., 1] / safe_z + cy
    mean2d = torch.stack([u, v], dim=-1)

    # Perspective Jacobian (2x3) with the standard EWA clamping of x/z, y/z.
    lim_x = frustum_margin * width / (2.0 * fx)
    lim_y = frustum_margin * height / (2.0 * fy)
    tx = torch.clamp(p_cam[..., 0] / safe_z, -lim_x, lim_x) * safe_z
    ty = torch.clamp(p_cam[..., 1] / safe_z, -lim_y, lim_y) * safe_z
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(inv_z)
    j = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * tx * inv_z2], -1),
        torch.stack([zeros, fy * inv_z, -fy * ty * inv_z2], -1),
    ], dim=-2)                                            # (N, 2, 3)

    cov3d = covariances_from(quats, log_scales)           # (N, 3, 3)
    m = j @ rot[None, :, :]                               # (N, 2, 3)
    cov2d_full = m @ cov3d @ m.transpose(-1, -2)          # (N, 2, 2)
    a = cov2d_full[..., 0, 0] + dilation
    b = cov2d_full[..., 0, 1]
    c = cov2d_full[..., 1, 1] + dilation

    det = a * c - b * b
    det_safe = torch.clamp_min(det, 1e-12)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    lam1, lam2, minor_axis = _eig2x2(a, b, c)
    radius3 = torch.ceil(3.0 * torch.sqrt(lam1))

    # eq. (4): effective radii where opacity falls to tau = 1/255.
    log_ratio = torch.log(torch.clamp_min(opacity / ALPHA_THRESHOLD,
                                          1.0 + 1e-6))
    r_major = torch.sqrt(2.0 * log_ratio * lam1)
    r_minor = torch.sqrt(2.0 * log_ratio * lam2)
    # eq. (6): tight bbox; half-width = sqrt(Sigma'_X / lam1) * R_major etc.
    half_w = torch.sqrt(torch.clamp_min(a / lam1, 0.0)) * r_major
    half_h = torch.sqrt(torch.clamp_min(c / lam1, 0.0)) * r_major

    in_front = z > near
    visible = opacity > ALPHA_THRESHOLD
    on_screen = ((u + radius3 > 0) & (u - radius3 < width)
                 & (v + radius3 > 0) & (v - radius3 < height))
    valid = in_front & visible & on_screen & (det > 1e-12)
    return PreprocessGeom(
        mean2d=mean2d, cov2d=torch.stack([a, b, c], -1), conic=conic,
        depth=z, radius3=radius3, eigvals=torch.stack([lam1, lam2], -1),
        minor_axis=minor_axis, r_major=r_major, r_minor=r_minor,
        tight_half_wh=torch.stack([half_w, half_h], -1), valid=valid)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """Define the Triton kernel (first use only: the CPU has no triton)."""
    import triton
    import triton.language as tl

    @triton.jit
    def preprocess_kernel(
            means_ptr, scales_ptr, quats_ptr, opac_ptr, w2c_ptr,
            mean2d_ptr, cov2d_ptr, conic_ptr, depth_ptr, radius3_ptr,
            eig_ptr, minor_ptr, rmaj_ptr, rmin_ptr, half_ptr, valid_ptr,
            n, fx, fy, cx, cy, width, height, lim_x, lim_y, near, dilation,
            alpha_thr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        msk = offs < n
        mx = tl.load(means_ptr + offs * 3 + 0, mask=msk, other=0.0)
        my = tl.load(means_ptr + offs * 3 + 1, mask=msk, other=0.0)
        mz = tl.load(means_ptr + offs * 3 + 2, mask=msk, other=0.0)
        ls0 = tl.load(scales_ptr + offs * 3 + 0, mask=msk, other=0.0)
        ls1 = tl.load(scales_ptr + offs * 3 + 1, mask=msk, other=0.0)
        ls2 = tl.load(scales_ptr + offs * 3 + 2, mask=msk, other=0.0)
        qw = tl.load(quats_ptr + offs * 4 + 0, mask=msk, other=1.0)
        qx = tl.load(quats_ptr + offs * 4 + 1, mask=msk, other=0.0)
        qy = tl.load(quats_ptr + offs * 4 + 2, mask=msk, other=0.0)
        qz = tl.load(quats_ptr + offs * 4 + 3, mask=msk, other=0.0)
        opac = tl.load(opac_ptr + offs, mask=msk, other=0.0)
        # Camera rows (world -> camera): w2c[:3, :3] and w2c[:3, 3].
        c00 = tl.load(w2c_ptr + 0)
        c01 = tl.load(w2c_ptr + 1)
        c02 = tl.load(w2c_ptr + 2)
        t0 = tl.load(w2c_ptr + 3)
        c10 = tl.load(w2c_ptr + 4)
        c11 = tl.load(w2c_ptr + 5)
        c12 = tl.load(w2c_ptr + 6)
        t1 = tl.load(w2c_ptr + 7)
        c20 = tl.load(w2c_ptr + 8)
        c21 = tl.load(w2c_ptr + 9)
        c22 = tl.load(w2c_ptr + 10)
        t2 = tl.load(w2c_ptr + 11)

        # Camera transform and projection.
        pcx = c00 * mx + c01 * my + c02 * mz + t0
        pcy = c10 * mx + c11 * my + c12 * mz + t1
        z = c20 * mx + c21 * my + c22 * mz + t2
        safe_z = tl.maximum(z, near)
        u = tl.div_rn(fx * pcx, safe_z) + cx
        v = tl.div_rn(fy * pcy, safe_z) + cy

        # Quaternion -> rotation (normalised as quat_to_rotmat does), then
        # M = R diag(s) and the world covariance M M^T.
        qn = tl.sqrt_rn(qw * qw + qx * qx + qy * qy + qz * qz) + 1e-12
        qw = tl.div_rn(qw, qn)
        qx = tl.div_rn(qx, qn)
        qy = tl.div_rn(qy, qn)
        qz = tl.div_rn(qz, qn)
        s0 = tl.exp(ls0)
        s1 = tl.exp(ls1)
        s2 = tl.exp(ls2)
        m00 = (1 - 2 * (qy * qy + qz * qz)) * s0
        m01 = (2 * (qx * qy - qw * qz)) * s1
        m02 = (2 * (qx * qz + qw * qy)) * s2
        m10 = (2 * (qx * qy + qw * qz)) * s0
        m11 = (1 - 2 * (qx * qx + qz * qz)) * s1
        m12 = (2 * (qy * qz - qw * qx)) * s2
        m20 = (2 * (qx * qz - qw * qy)) * s0
        m21 = (2 * (qy * qz + qw * qx)) * s1
        m22 = (1 - 2 * (qx * qx + qy * qy)) * s2
        v00 = m00 * m00 + m01 * m01 + m02 * m02
        v01 = m00 * m10 + m01 * m11 + m02 * m12
        v02 = m00 * m20 + m01 * m21 + m02 * m22
        v11 = m10 * m10 + m11 * m11 + m12 * m12
        v12 = m10 * m20 + m11 * m21 + m12 * m22
        v22 = m20 * m20 + m21 * m21 + m22 * m22

        # EWA Jacobian with tx/ty clamped to the widened frustum.
        tx = tl.minimum(tl.maximum(tl.div_rn(pcx, safe_z), -lim_x), lim_x) \
            * safe_z
        ty = tl.minimum(tl.maximum(tl.div_rn(pcy, safe_z), -lim_y), lim_y) \
            * safe_z
        inv_z = tl.div_rn(tl.full([BLOCK], 1.0, tl.float32), safe_z)
        inv_z2 = inv_z * inv_z
        j00 = fx * inv_z
        j02 = -fx * tx * inv_z2
        j11 = fy * inv_z
        j12 = -fy * ty * inv_z2
        # W = J @ Rcam (2x3), then cov2d = (W V) W^T.
        w00 = j00 * c00 + j02 * c20
        w01 = j00 * c01 + j02 * c21
        w02 = j00 * c02 + j02 * c22
        w10 = j11 * c10 + j12 * c20
        w11 = j11 * c11 + j12 * c21
        w12 = j11 * c12 + j12 * c22
        p00 = w00 * v00 + w01 * v01 + w02 * v02
        p01 = w00 * v01 + w01 * v11 + w02 * v12
        p02 = w00 * v02 + w01 * v12 + w02 * v22
        p10 = w10 * v00 + w11 * v01 + w12 * v02
        p11 = w10 * v01 + w11 * v11 + w12 * v12
        p12 = w10 * v02 + w11 * v12 + w12 * v22
        a = p00 * w00 + p01 * w01 + p02 * w02 + dilation
        b = p00 * w10 + p01 * w11 + p02 * w12
        c = p10 * w10 + p11 * w11 + p12 * w12 + dilation

        det = a * c - b * b
        det_safe = tl.maximum(det, 1e-12)
        con_a = tl.div_rn(c, det_safe)
        con_b = tl.div_rn(-b, det_safe)
        con_c = tl.div_rn(a, det_safe)

        # 2x2 eigen-decomposition; minor axis = eigenvector of lam2.
        mid = 0.5 * (a + c)
        half_diff = 0.5 * (a - c)
        disc = tl.sqrt_rn(tl.maximum(half_diff * half_diff + b * b, 1e-12))
        lam1 = mid + disc
        lam2 = tl.maximum(mid - disc, 1e-8)
        big_b = tl.abs(b) > 1e-12
        ex = tl.where(big_b, b, tl.where(a <= c, 1.0, 0.0))
        ey = tl.where(big_b, lam2 - a, tl.where(a <= c, 0.0, 1.0))
        en = tl.sqrt_rn(ex * ex + ey * ey) + 1e-12

        radius3 = tl.ceil(3.0 * tl.sqrt_rn(lam1))
        # eq. (4) radii and eq. (6) tight-bbox half extents.
        log_ratio = tl.log(tl.maximum(tl.div_rn(opac, alpha_thr),
                                      1.0 + 1e-6))
        r_major = tl.sqrt_rn(2.0 * log_ratio * lam1)
        r_minor = tl.sqrt_rn(2.0 * log_ratio * lam2)
        half_w = tl.sqrt_rn(tl.maximum(tl.div_rn(a, lam1), 0.0)) * r_major
        half_h = tl.sqrt_rn(tl.maximum(tl.div_rn(c, lam1), 0.0)) * r_major

        on_screen = ((u + radius3 > 0) & (u - radius3 < width)
                     & (v + radius3 > 0) & (v - radius3 < height))
        valid = (z > near) & (opac > alpha_thr) & on_screen & (det > 1e-12)

        tl.store(mean2d_ptr + offs * 2 + 0, u, mask=msk)
        tl.store(mean2d_ptr + offs * 2 + 1, v, mask=msk)
        tl.store(cov2d_ptr + offs * 3 + 0, a, mask=msk)
        tl.store(cov2d_ptr + offs * 3 + 1, b, mask=msk)
        tl.store(cov2d_ptr + offs * 3 + 2, c, mask=msk)
        tl.store(conic_ptr + offs * 3 + 0, con_a, mask=msk)
        tl.store(conic_ptr + offs * 3 + 1, con_b, mask=msk)
        tl.store(conic_ptr + offs * 3 + 2, con_c, mask=msk)
        tl.store(depth_ptr + offs, z, mask=msk)
        tl.store(radius3_ptr + offs, radius3, mask=msk)
        tl.store(eig_ptr + offs * 2 + 0, lam1, mask=msk)
        tl.store(eig_ptr + offs * 2 + 1, lam2, mask=msk)
        tl.store(minor_ptr + offs * 2 + 0, tl.div_rn(ex, en), mask=msk)
        tl.store(minor_ptr + offs * 2 + 1, tl.div_rn(ey, en), mask=msk)
        tl.store(rmaj_ptr + offs, r_major, mask=msk)
        tl.store(rmin_ptr + offs, r_minor, mask=msk)
        tl.store(half_ptr + offs * 2 + 0, half_w, mask=msk)
        tl.store(half_ptr + offs * 2 + 1, half_h, mask=msk)
        tl.store(valid_ptr + offs, valid.to(tl.int8), mask=msk)

    return triton, preprocess_kernel


def _check_inputs(means, log_scales, quats, opacity, w2c):
    n = means.shape[0]
    shapes = {"means": (means, (n, 3)), "log_scales": (log_scales, (n, 3)),
              "quats": (quats, (n, 4)), "opacity": (opacity, (n,)),
              "w2c": (w2c, (4, 4))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype} != torch.float32")
        if x.device != means.device:
            raise ValueError(f"{name} is on {x.device}, means on "
                             f"{means.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def preprocess_geom_triton(means, log_scales, quats, opacity, w2c,
                           intrin: Sequence[float], *, near: float = 0.05,
                           frustum_margin: float = 1.3,
                           dilation: float = COV2D_DILATION
                           ) -> PreprocessGeom:
    """Launch the Triton kernel on CUDA tensors (no counting; see wrapper)."""
    _check_inputs(means, log_scales, quats, opacity, w2c)
    if means.device.type != "cuda":
        raise ValueError("the Triton preprocess kernel needs CUDA tensors")
    triton, kernel = _triton_kernel()
    fx, fy, cx, cy, width, height = (float(v) for v in intrin)
    n = means.shape[0]
    f32 = dict(dtype=torch.float32, device=means.device)
    out = PreprocessGeom(
        mean2d=torch.empty((n, 2), **f32), cov2d=torch.empty((n, 3), **f32),
        conic=torch.empty((n, 3), **f32), depth=torch.empty((n,), **f32),
        radius3=torch.empty((n,), **f32), eigvals=torch.empty((n, 2), **f32),
        minor_axis=torch.empty((n, 2), **f32),
        r_major=torch.empty((n,), **f32), r_minor=torch.empty((n,), **f32),
        tight_half_wh=torch.empty((n, 2), **f32),
        valid=torch.empty((n,), dtype=torch.int8, device=means.device))
    if n:
        grid = (triton.cdiv(n, BLOCK),)
        kernel[grid](
            means, log_scales, quats, opacity, w2c, *out,
            n, fx, fy, cx, cy, width, height,
            frustum_margin * width / (2.0 * fx),
            frustum_margin * height / (2.0 * fy),
            float(near), float(dilation), ALPHA_THRESHOLD,
            BLOCK=BLOCK, num_warps=4)
    return out._replace(valid=out.valid.view(torch.bool))


def preprocess_geom(means, log_scales, quats, opacity, w2c,
                    intrin: Sequence[float], *, near: float = 0.05,
                    frustum_margin: float = 1.3,
                    dilation: float = COV2D_DILATION) -> PreprocessGeom:
    """Preprocess geometry for N Gaussians on the device of ``means``.

    CPU tensors run the plain version; CUDA tensors launch the Triton
    kernel (or raise) and add one to ``preprocess_geom.launches``.
    """
    kw = dict(near=near, frustum_margin=frustum_margin, dilation=dilation)
    if means.device.type == "cpu":
        return preprocess_geom_torch(means, log_scales, quats, opacity, w2c,
                                     intrin, **kw)
    out = preprocess_geom_triton(means, log_scales, quats, opacity, w2c,
                                 intrin, **kw)
    preprocess_geom.launches += 1
    return out


preprocess_geom.launches = 0


def build(device="cuda") -> float:
    """Compile the Triton kernel with one tiny launch; returns seconds."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    one = dict(dtype=torch.float32, device=dev)
    preprocess_geom_triton(
        torch.zeros((1, 3), **one), torch.zeros((1, 3), **one),
        torch.tensor([[1.0, 0.0, 0.0, 0.0]], **one), torch.ones((1,), **one),
        torch.eye(4, **one), (1.0, 1.0, 0.0, 0.0, 16.0, 16.0))
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0
