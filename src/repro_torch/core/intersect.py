"""Gaussian-tile intersection tests (port of ``repro/core/intersect.py``,
paper Sec. IV-C).

Every test returns a boolean mask (N, T) and reads only
``origins``/``centers`` from its grid argument, so a compacted
``TileSlots`` view (``take_tiles``) gives a plan-shaped (N, R) mask:

- ``aabb_mask``        : 3DGS's square of the 3-sigma circle (baseline).
- ``obb_mask``         : GSCore-style oriented-box separating-axis test.
- ``tait_stage1_mask`` : TAIT stage 1, the opacity-aware tight bbox.
- ``tait_mask``        : TAIT stage 1, then the minor-axis rejection (eq. 7)
                         in its safe form ``|l| cos(theta) - r > R_minor``.
- ``exact_mask``       : analytic ellipse-vs-rectangle oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.camera import TILE, Camera
from repro_torch.core.projection import ProjectedGaussians

# Circumcircle radius of a 16x16 tile (r in eq. 7).
TILE_CIRCUMRADIUS = float(TILE) * (2.0 ** 0.5) / 2.0


class TileGrid(NamedTuple):
    tiles_x: int
    tiles_y: int
    centers: torch.Tensor  # (T, 2) pixel coords of tile centers
    origins: torch.Tensor  # (T, 2) pixel coords of tile upper-left corners

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


class TileSlots(NamedTuple):
    """Compacted view of R plan slots — duck-typed grid for the tests."""

    centers: torch.Tensor  # (R, 2)
    origins: torch.Tensor  # (R, 2)


def take_tiles(grid, tile_ids: torch.Tensor) -> TileSlots:
    """Gather the grid rows of a plan's tile ids: (T,)-world -> (R,)-world."""
    idx = tile_ids.long()
    return TileSlots(centers=grid.centers[idx], origins=grid.origins[idx])


def make_tile_grid(cam: Camera) -> TileGrid:
    f32 = dict(dtype=torch.float32, device=cam.device)
    tx = torch.arange(cam.tiles_x, **f32) * TILE
    ty = torch.arange(cam.tiles_y, **f32) * TILE
    ox, oy = torch.meshgrid(tx, ty, indexing="xy")
    origins = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)
    centers = origins + TILE / 2.0
    return TileGrid(cam.tiles_x, cam.tiles_y, centers, origins)


def _rect_overlap(mean2d, half_wh, grid) -> torch.Tensor:
    """Axis-aligned rectangle (center, half-extent) vs every tile. (N, T)."""
    lo = mean2d - half_wh                                       # (N, 2)
    hi = mean2d + half_wh
    t_lo = grid.origins                                         # (T, 2)
    t_hi = grid.origins + TILE
    ov_x = (lo[:, None, 0] < t_hi[None, :, 0]) & (hi[:, None, 0] > t_lo[None, :, 0])
    ov_y = (lo[:, None, 1] < t_hi[None, :, 1]) & (hi[:, None, 1] > t_lo[None, :, 1])
    return ov_x & ov_y


def aabb_mask(proj: ProjectedGaussians, grid) -> torch.Tensor:
    """Original 3DGS test: square of half-extent 3*sqrt(lambda1). (N, T)."""
    r = proj.radius3[:, None]
    half = torch.cat([r, r], dim=-1)
    return _rect_overlap(proj.mean2d, half, grid) & proj.valid[:, None]


def tait_stage1_mask(proj: ProjectedGaussians, grid) -> torch.Tensor:
    """Stage 1: opacity-aware tight bbox of the effective ellipse. (N, T)."""
    return (_rect_overlap(proj.mean2d, proj.tight_half_wh, grid)
            & proj.valid[:, None])


def _along(d: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """(N, T, 2) offsets dotted with per-Gaussian (N, 2) axes. (N, T)."""
    return d[..., 0] * axis[:, None, 0] + d[..., 1] * axis[:, None, 1]


def tait_stage2_keep(proj: ProjectedGaussians, grid) -> torch.Tensor:
    """Stage 2 (eq. 7, safe form): keep unless the tile center's offset
    along the minor axis exceeds R_minor + the tile circumradius. (N, T)."""
    d = grid.centers[None, :, :] - proj.mean2d[:, None, :]      # (N, T, 2)
    along_minor = _along(d, proj.minor_axis).abs()
    return along_minor - TILE_CIRCUMRADIUS <= proj.r_minor[:, None]


def tait_mask(proj: ProjectedGaussians, grid) -> torch.Tensor:
    """Full two-stage TAIT test (stage 1 bbox, then eq. 7 rejection)."""
    return tait_stage1_mask(proj, grid) & tait_stage2_keep(proj, grid)


def obb_mask(proj: ProjectedGaussians, grid) -> torch.Tensor:
    """GSCore-style OBB vs tile square, separating-axis theorem. (N, T)."""
    minor = proj.minor_axis                                     # (N, 2)
    major = torch.stack([-minor[:, 1], minor[:, 0]], dim=-1)
    d = grid.centers[None, :, :] - proj.mean2d[:, None, :]      # (N, T, 2)
    half_t = TILE / 2.0
    rmaj = proj.r_major[:, None]
    rmin = proj.r_minor[:, None]

    obb_px = major[:, 0:1].abs() * rmaj + minor[:, 0:1].abs() * rmin
    sep_x = d[..., 0].abs() > (obb_px + half_t)
    obb_py = major[:, 1:2].abs() * rmaj + minor[:, 1:2].abs() * rmin
    sep_y = d[..., 1].abs() > (obb_py + half_t)
    tile_pm = half_t * (major[:, 0:1].abs() + major[:, 1:2].abs())
    sep_maj = _along(d, major).abs() > (rmaj + tile_pm)
    tile_pn = half_t * (minor[:, 0:1].abs() + minor[:, 1:2].abs())
    sep_min = _along(d, minor).abs() > (rmin + tile_pn)

    separated = sep_x | sep_y | sep_maj | sep_min
    return (~separated) & proj.valid[:, None]


def exact_mask(proj: ProjectedGaussians, grid) -> torch.Tensor:
    """Analytic oracle: does the effective ellipse touch the tile rectangle?

    The effective ellipse is {p : (p-mu)^T Sigma^-1 (p-mu) <= rho2} with
    rho2 = 2 ln(o / tau). A rectangle intersects iff the quadratic's
    minimum over it is <= rho2: 0 if the center is inside, else the least
    of the four clamped edge minima.
    """
    mu = proj.mean2d
    con_a, con_b, con_c = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    rho2 = 2.0 * torch.log(torch.clamp_min(proj.opacity / (1.0 / 255.0),
                                           1.0 + 1e-6))
    lo = grid.origins
    hi = grid.origins + TILE

    def quad(dx, dy):
        return con_a[:, None] * dx * dx + 2.0 * con_b[:, None] * dx * dy \
            + con_c[:, None] * dy * dy

    inside = ((mu[:, None, 0] >= lo[None, :, 0]) & (mu[:, None, 0] <= hi[None, :, 0])
              & (mu[:, None, 1] >= lo[None, :, 1]) & (mu[:, None, 1] <= hi[None, :, 1]))

    def vedge(x0):
        dx = x0[None, :] - mu[:, 0:1]                           # (N, T)
        dy_star = -con_b[:, None] * dx / torch.clamp_min(con_c[:, None], 1e-12)
        dy = torch.clamp(dy_star, lo[None, :, 1] - mu[:, 1:2],
                         hi[None, :, 1] - mu[:, 1:2])
        return quad(dx, dy)

    def hedge(y0):
        dy = y0[None, :] - mu[:, 1:2]
        dx_star = -con_b[:, None] * dy / torch.clamp_min(con_a[:, None], 1e-12)
        dx = torch.clamp(dx_star, lo[None, :, 0] - mu[:, 0:1],
                         hi[None, :, 0] - mu[:, 0:1])
        return quad(dx, dy)

    qmin = torch.minimum(torch.minimum(vedge(lo[:, 0]), vedge(hi[:, 0])),
                         torch.minimum(hedge(lo[:, 1]), hedge(hi[:, 1])))
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    return (qmin <= rho2[:, None]) & proj.valid[:, None]


def pair_count(mask: torch.Tensor) -> torch.Tensor:
    """Total Gaussian-tile pairs a test admits (Fig. 9 metric)."""
    return mask.sum(dtype=torch.int32)


def per_tile_count(mask: torch.Tensor) -> torch.Tensor:
    """(T,) pairs per tile — the tile workload before DPES."""
    return mask.sum(dim=0, dtype=torch.int32)


def intersect(proj: ProjectedGaussians, grid, method: str) -> torch.Tensor:
    fns = {"aabb": aabb_mask, "obb": obb_mask, "tait": tait_mask,
           "tait_stage1": tait_stage1_mask, "exact": exact_mask}
    return fns[method](proj, grid)
