"""Preprocess geometry: a CUDA kernel and its plain PyTorch version.

Replaces ``repro/kernels/preprocess.py::_preproc_kernel`` (the paper's
CCU, reached through ``preprocess_geom_pallas``). Per Gaussian: camera
transform and projection, quaternion -> rotation, 3D covariance, the EWA
Jacobian with tx/ty clamped to the frustum, 2D covariance + dilation,
conic, 2x2 eigen-decomposition, ``radius3``, the TAIT radii (eq. 4) and
the tight-bbox half extents (eq. 6), and validity. It emits every
geometry field ``ProjectedGaussians`` carries (a superset of the Pallas
kernel's outputs); SH colour and the sigmoid opacity stay in torch
(``core/projection.py``).

The kernel is ``csrc/preprocess.cu``: one thread per Gaussian, each of
a warp's loads and stores coalesced, the outputs written into one buffer
that ``alloc_outputs`` carves into the fields (``output_layout``), the
scalars passed by value (``pack_params``). What bounds it and what the
design does about it is in the source.

``preprocess_geom`` is the wrapper: CPU tensors take the plain version
(the ported ``projection.preprocess`` math), CUDA tensors launch the
kernel (or raise), and ``kernel_launches_total{kernel="preprocess_geom"}``
counts those launches.
"""
from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.gaussians import covariances_from
from repro_torch.kernels import _build
from repro_torch.obs.metrics import kernel_launches

_LAUNCHES = kernel_launches("preprocess_geom")

# Opacity threshold below which a Gaussian does not contribute (1/255).
ALPHA_THRESHOLD = 1.0 / 255.0
# Low-pass dilation added to the projected covariance diagonal.
COV2D_DILATION = 0.3


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


# Output fields in the buffer's order with their widths (float32 words a
# Gaussian); ``valid`` (one byte a Gaussian) follows them. The kernel
# (``field_width`` / ``field_offset`` in csrc/preprocess.cu) writes this
# layout.
FIELDS = (("mean2d", 2), ("cov2d", 3), ("conic", 3), ("depth", 1),
          ("radius3", 1), ("eigvals", 2), ("minor_axis", 2), ("r_major", 1),
          ("r_minor", 1), ("tight_half_wh", 2))


def output_layout(n: int):
    """(stride, {field: word offset}, total words) of the kernel's output
    buffer for ``n`` Gaussians: field f starts at the stride S =
    round_up(n, 4) times the widths before it (16-byte aligned), and
    ``valid``'s n bytes after them (at 18 S)."""
    stride = (n + 3) // 4 * 4
    offsets, at = {}, 0
    for name, width in FIELDS:
        offsets[name] = at * stride
        at += width
    offsets["valid"] = at * stride
    return stride, offsets, at * stride + stride // 4


def alloc_outputs(n: int, device) -> PreprocessGeom:
    """One buffer carved into the 11 fields as views (``output_layout``);
    ``valid`` is a bool view of the bytes after the float fields."""
    _, offsets, total = output_layout(n)
    buf = torch.empty((total,), dtype=torch.float32, device=device)
    views = {}
    for name, width in FIELDS:
        shape, strides = ((n,), (1,)) if width == 1 else ((n, width),
                                                           (width, 1))
        views[name] = buf.as_strided(shape, strides, offsets[name])
    views["valid"] = buf.view(torch.uint8).as_strided(
        (n,), (1,), 4 * offsets["valid"]).view(torch.bool)
    return PreprocessGeom(**views)


class Params(ctypes.Structure):
    """The kernel's by-value scalars (``PreprocessParams`` in
    csrc/preprocess.cu)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "fx", "fy", "cx", "cy", "width", "height", "lim_x", "lim_y", "near",
        "dilation", "alpha_thr")] + [("n", ctypes.c_int)]


def pack_params(n: int, intrin: Sequence[float], *, near: float = 0.05,
                frustum_margin: float = 1.3,
                dilation: float = COV2D_DILATION) -> Params:
    """The scalars ``preprocess_geom_torch`` uses, as the kernel takes
    them (float32): intrinsics, the frustum limits lim_x = margin * width
    / (2 fx) and lim_y, near, dilation and ALPHA_THRESHOLD."""
    fx, fy, cx, cy, width, height = (float(v) for v in intrin)
    return Params(fx, fy, cx, cy, width, height,
                  frustum_margin * width / (2.0 * fx),
                  frustum_margin * height / (2.0 * fy), near, dilation,
                  ALPHA_THRESHOLD, n)


def _c_function():
    fn = _build.load_library("preprocess").preprocess_geom
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [Params, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def preprocess_geom_cuda(means, log_scales, quats, opacity, w2c,
                         intrin: Sequence[float], *, near: float = 0.05,
                         frustum_margin: float = 1.3,
                         dilation: float = COV2D_DILATION) -> PreprocessGeom:
    """Launch ``csrc/preprocess.cu`` on CUDA tensors (no counting; see
    the wrapper)."""
    _check_inputs(means, log_scales, quats, opacity, w2c)
    if means.device.type != "cuda":
        raise ValueError("the preprocess kernel needs CUDA tensors")
    n = means.shape[0]
    out = alloc_outputs(n, means.device)
    err = _c_function()(
        means.data_ptr(), log_scales.data_ptr(), quats.data_ptr(),
        opacity.data_ptr(), w2c.data_ptr(), out.mean2d.data_ptr(),
        pack_params(n, intrin, near=near, frustum_margin=frustum_margin,
                    dilation=dilation),
        torch.cuda.current_stream(means.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"preprocess_geom launch failed: CUDA error "
                           f"{err}")
    return out


def preprocess_geom(means, log_scales, quats, opacity, w2c,
                    intrin: Sequence[float], *, near: float = 0.05,
                    frustum_margin: float = 1.3,
                    dilation: float = COV2D_DILATION) -> PreprocessGeom:
    """Preprocess geometry for N Gaussians on the device of ``means``.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise) and add one to its ``kernel_launches_total``.
    """
    kw = dict(near=near, frustum_margin=frustum_margin, dilation=dilation)
    if means.device.type == "cpu":
        return preprocess_geom_torch(means, log_scales, quats, opacity, w2c,
                                     intrin, **kw)
    out = preprocess_geom_cuda(means, log_scales, quats, opacity, w2c,
                               intrin, **kw)
    _LAUNCHES.inc()
    return out



def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("preprocess")
    _build.load_library.cache_clear()
    _build.load_library("preprocess")
    return time.perf_counter() - t0, report
