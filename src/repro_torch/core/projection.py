"""Preprocessing stage: cull + project Gaussians to the image plane
(port of ``repro/core/projection.py``).

EWA splatting projection as in 3DGS (Sec. II-A of the paper) plus what
TAIT (Sec. IV-C) needs downstream: eigenvalues and eigenvectors of the
2D covariance, opacity-aware effective radii (eq. 4) and the tight
bounding box (eq. 6). The geometry comes from
``kernels/preprocess.py::preprocess_geom`` (the CUDA kernel on CUDA
tensors, its plain version on the CPU); SH colour and the sigmoid opacity are
computed here in torch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import gaussians as G
from repro_torch.core.camera import Camera, camera_position
from repro_torch.kernels.preprocess import (ALPHA_THRESHOLD, COV2D_DILATION,
                                            preprocess_geom)

__all__ = ["ALPHA_THRESHOLD", "COV2D_DILATION", "ProjectedGaussians",
           "preprocess"]


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities (N rows)."""

    mean2d: torch.Tensor      # (N, 2) pixel coords of projected center
    cov2d: torch.Tensor       # (N, 3) upper-tri 2D covariance (a, b, c)
    conic: torch.Tensor       # (N, 3) inverse covariance (A, B, C)
    depth: torch.Tensor       # (N,)  camera-space z
    rgb: torch.Tensor         # (N, 3) SH-evaluated colour for this view
    opacity: torch.Tensor     # (N,)
    radius3: torch.Tensor     # (N,)  classic 3*sqrt(lambda1) radius
    eigvals: torch.Tensor     # (N, 2) (lambda1 >= lambda2) of cov2d
    minor_axis: torch.Tensor  # (N, 2) unit eigenvector of lambda2
    r_major: torch.Tensor     # (N,)  TAIT effective semi-major radius
    r_minor: torch.Tensor     # (N,)  TAIT effective semi-minor radius
    tight_half_wh: torch.Tensor  # (N, 2) TAIT tight bbox half (W/2, H/2)
    valid: torch.Tensor       # (N,)  bool: in frustum, visible, non-degenerate


def preprocess(scene: G.GaussianScene, cam: Camera, *,
               near: float = 0.05, frustum_margin: float = 1.3,
               dilation: float = COV2D_DILATION) -> ProjectedGaussians:
    """Project every Gaussian into the view; compute TAIT geometry.

    ``frustum_margin`` widens the cull window (a Gaussian slightly outside
    the image can still splat into it).
    """
    opacity = G.opacities(scene)
    geom = preprocess_geom(
        scene.means, scene.log_scales, scene.quats, opacity, cam.w2c,
        (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height),
        near=near, frustum_margin=frustum_margin, dilation=dilation)

    dirs = scene.means - camera_position(cam)
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = G.eval_sh(scene.sh, dirs)
    return ProjectedGaussians(rgb=rgb, opacity=opacity, **geom._asdict())
