"""3D Gaussian scene representation (port of ``repro/core/gaussians.py``).

A scene is a NamedTuple of per-Gaussian parameter tensors (Kerbl et al.
3DGS): position, anisotropic scale (log-space), rotation quaternion,
opacity (logit-space) and spherical-harmonic colour coefficients.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Real SH basis constants (degree <= 3), matching the reference 3DGS CUDA
# implementation.
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class GaussianScene(NamedTuple):
    """Per-Gaussian parameters. N = number of Gaussians, K = (sh_degree+1)^2."""

    means: torch.Tensor           # (N, 3) world-space centers
    log_scales: torch.Tensor      # (N, 3) log of per-axis stddev
    quats: torch.Tensor           # (N, 4) rotation quaternion (w, x, y, z)
    opacity_logits: torch.Tensor  # (N,)  sigmoid -> opacity in (0, 1)
    sh: torch.Tensor              # (N, K, 3) SH colour coefficients

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return {1: 0, 4: 1, 9: 2, 16: 3}[self.sh.shape[1]]


def opacities(scene: GaussianScene) -> torch.Tensor:
    """(N,) opacity in (0,1)."""
    return torch.sigmoid(scene.opacity_logits)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    rows = [torch.stack([r00, r01, r02], -1),
            torch.stack([r10, r11, r12], -1),
            torch.stack([r20, r21, r22], -1)]
    return torch.stack(rows, -2)


def covariances(scene: GaussianScene) -> torch.Tensor:
    """World-space 3x3 covariance per Gaussian: R S S^T R^T. (N, 3, 3)."""
    return covariances_from(scene.quats, scene.log_scales)


def covariances_from(quats: torch.Tensor,
                     log_scales: torch.Tensor) -> torch.Tensor:
    """``covariances`` over raw (N, 4) quaternions and (N, 3) log scales."""
    rot = quat_to_rotmat(quats)                           # (N, 3, 3)
    scale = torch.exp(log_scales)                         # (N, 3)
    m = rot * scale[:, None, :]                           # R @ diag(s)
    return m @ m.transpose(-1, -2)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH colour in view directions.

    sh: (N, K, 3) with K in {1, 4, 9, 16}; dirs: (N, 3) unit vectors
    (gaussian center - camera position, normalized). Returns (N, 3) RGB,
    clamped at 0 like the reference implementation (+0.5 offset).
    """
    k = sh.shape[1]
    result = SH_C0 * sh[:, 0]
    if k > 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        result = (result - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
                  - SH_C1 * x * sh[:, 3])
        if k > 4:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[:, 4]
                      + SH_C2[1] * yz * sh[:, 5]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
                      + SH_C2[3] * xz * sh[:, 7]
                      + SH_C2[4] * (xx - yy) * sh[:, 8])
            if k > 9:
                result = (result
                          + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
                          + SH_C3[1] * xy * z * sh[:, 10]
                          + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
                          + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                          * sh[:, 12]
                          + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
                          + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                          + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(result + 0.5, 0.0)


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the degree-0 term: store a flat RGB as the DC coefficient."""
    return (rgb - 0.5) / SH_C0
