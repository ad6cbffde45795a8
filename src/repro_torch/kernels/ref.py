"""Sequential oracles for the kernels (port of ``repro/kernels/ref.py``).

Semantics match the reference 3DGS CUDA rasterizer exactly:
  - per-Gaussian alpha = min(0.99, opacity * exp(power)); skipped (no state
    update) when alpha < 1/255;
  - front-to-back blending, and a pixel is *done* at the first Gaussian
    whose blend would push transmittance below 1e-4 — that Gaussian is NOT
    blended, and the flag is sticky;
  - outputs: blended rgb, final transmittance, normalized opacity-weighted
    expected depth (Sec. IV-A), the truncated depth (depth of the last
    blended Gaussian, Sec. IV-B), the processed-pair count, and the
    per-lane blend contribution (sum of ``alpha * T_before`` over the
    tile's pixels).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.camera import TILE
from repro_torch.kernels.preprocess import (pallas_layout,
                                            preprocess_geom_torch)

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def pixel_coords(origins: torch.Tensor, tile: int = TILE
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coords of tiles. origins (R, 2) -> (R, tile*tile) each.

    Pixel p of a tile is row ``p // tile``, column ``p % tile``.
    """
    ii = torch.arange(tile, dtype=torch.float32, device=origins.device)
    py, px = torch.meshgrid(ii, ii, indexing="ij")
    px = px.reshape(1, -1) + origins[:, 0:1] + 0.5
    py = py.reshape(1, -1) + origins[:, 1:2] + 0.5
    return px, py


def alpha_of(opacity, power):
    """alpha = min(o * exp(power), 0.99), zeroed below 1/255 (NaN -> 0)."""
    alpha = torch.clamp_max(opacity * torch.exp(power), ALPHA_MAX)
    return torch.where(alpha >= ALPHA_MIN, alpha, torch.zeros_like(alpha))


def raster_tiles_ref(mean2d, conic, rgb, opacity, depth, origins, *,
                     tile: int = TILE):
    """Rasterize R tiles by a sequential scan over each tile's K lanes.

    mean2d (R,K,2), conic (R,K,3), rgb (R,K,3), opacity (R,K), depth (R,K),
    origins (R,2); lanes must be depth-sorted, invalid lanes opacity 0.
    Returns rgb (R,tile,tile,3), trans, exp_depth, trunc_depth (each
    (R,tile,tile)), processed (R,) int32 (exact pair count), lane_contrib
    (R,K) float32.
    """
    r, k = opacity.shape
    px, py = pixel_coords(origins, tile)                  # (R, P)
    p = tile * tile
    f32 = dict(dtype=torch.float32, device=opacity.device)
    color = torch.zeros((r, p, 3), **f32)
    trans = torch.ones((r, p), **f32)
    done = torch.zeros((r, p), dtype=torch.bool, device=opacity.device)
    dacc = torch.zeros((r, p), **f32)
    wacc = torch.zeros((r, p), **f32)
    tdepth = torch.zeros((r, p), **f32)
    n_proc = torch.zeros((r,), dtype=torch.int32, device=opacity.device)
    contrib = torch.zeros((r, k), **f32)
    for j in range(k):
        o = opacity[:, j:j + 1]
        d = depth[:, j:j + 1]
        n_proc += ((~done).any(dim=1) & (o[:, 0] > 0.0)).to(torch.int32)
        dx = px - mean2d[:, j:j + 1, 0]
        dy = py - mean2d[:, j:j + 1, 1]
        con = conic[:, j]
        power = (-0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy)
                 - con[:, 1:2] * dx * dy)
        alpha = alpha_of(o, power)
        test_t = trans * (1.0 - alpha)
        trigger = (alpha > 0.0) & (test_t < T_EPS)
        blend = (alpha > 0.0) & ~done & ~trigger
        w = torch.where(blend, alpha * trans, torch.zeros_like(alpha))
        color = color + w[..., None] * rgb[:, j:j + 1, :]
        dacc = dacc + w * d
        wacc = wacc + w
        tdepth = torch.where(blend, torch.maximum(tdepth, d), tdepth)
        trans = torch.where(blend, test_t, trans)
        done = done | trigger
        contrib[:, j] = w.sum(dim=1)
    exp_depth = dacc / torch.clamp_min(wacc, 1e-8)
    shape = (r, tile, tile)
    return (color.reshape(r, tile, tile, 3), trans.reshape(shape),
            exp_depth.reshape(shape), tdepth.reshape(shape), n_proc, contrib)


def raster_tile_ref(mean2d, conic, rgb, opacity, depth, origin, *,
                    tile: int = TILE):
    """One tile: inputs (K, ...) and origin (2,); outputs without the R axis."""
    outs = raster_tiles_ref(mean2d[None], conic[None], rgb[None],
                            opacity[None], depth[None], origin[None],
                            tile=tile)
    return tuple(o[0] for o in outs)


def preprocess_geom_ref(means, log_scales, quats, opacity, w2c,
                        intrin: Sequence[float], *, dilation: float = 0.3,
                        near: float = 0.05, frustum_margin: float = 1.3):
    """Oracle for the preprocess kernel, in the Pallas kernel's layout.

    intrin = (fx, fy, cx, cy, width, height). Returns mean2d (N,2), conic
    (N,3), depth (N,), aux (N,6) = [radius3, r_major, r_minor, half_w,
    half_h, valid], minor_axis (N,2).
    """
    return pallas_layout(preprocess_geom_torch(
        means, log_scales, quats, opacity, w2c, intrin, near=near,
        frustum_margin=frustum_margin, dilation=dilation))


def tile_sort_ref(keys: torch.Tensor, values: torch.Tensor):
    """Oracle for the per-tile bitonic sorter: ascending stable sort of
    each row. keys (T, K) float, values (T, K) int32. Returns sorted
    (keys, values)."""
    order = torch.argsort(keys, dim=-1, stable=True)
    return (torch.take_along_dim(keys, order, dim=-1),
            torch.take_along_dim(values, order, dim=-1))
