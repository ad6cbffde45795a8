"""TWSR — Tile-Warping-based Sparse Rendering (port of
``repro/core/warp.py``, paper Sec. IV-A, Algo. 1).

Given a reference frame (colour + estimated depth + truncated depth + a
source-validity mask), reproject it into the target viewpoint:

  1. back-project every valid reference pixel with its estimated depth
     (and, separately, its truncated depth);
  2. project the point clouds into the target camera; z-buffer with a
     two-pass scatter-min (ties within 1e-5 averaged);
  3. per 16x16 tile: interpolate when more than N0 (5/6 of the tile)
     pixels arrived, else re-render with the DPES early-stop depth = the
     max reprojected truncated depth;
  4. interpolated pixels are not sources for the next frame's warp.

The float scatter-adds go through ``raster.scatter_add``, which sorts
the indices, so that they repeat bit for bit on CUDA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.camera import TILE, Camera, backproject
from repro_torch.core.raster import scatter_add, tile_view

# A pixel is a usable reprojection source only if enough opacity
# accumulated behind it in the reference render.
MIN_COVERAGE = 0.25
# Paper: interpolate when > 5/6 of the tile's pixels arrived.
N0_RATIO = 5.0 / 6.0


class WarpResult(NamedTuple):
    rgb: torch.Tensor              # (H, W, 3) reprojected colour (holes = 0)
    filled: torch.Tensor           # (H, W) bool — pixel received a source
    exp_depth: torch.Tensor        # (H, W) reprojected scene depth
    trunc_depth: torch.Tensor      # (H, W) reprojected truncated depth
    valid_per_tile: torch.Tensor   # (T,) int32 — N in Algo. 1
    interpolate_tile: torch.Tensor  # (T,) bool — Algo. 1 line 7 branch
    rerender_tile: torch.Tensor    # (T,) bool
    dpes_depth: torch.Tensor       # (T,) early-stop depth (inf if unusable)


def _scatter_zbuffer(ti: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                     values: torch.Tensor, size: int):
    """Two-pass deterministic z-buffer scatter.

    ti: (S,) flat target pixel index; z: (S,) depth; valid: (S,) bool;
    values: (S, C). Returns (zmin (size,), out (size, C), hit (size,)).
    Ties within 1e-5 of the winning depth are averaged.
    """
    big = 1e30
    zs = torch.where(valid, z, big)
    ti_safe = torch.where(valid, ti, 0).long()
    zmin = torch.full((size,), big, dtype=z.dtype, device=z.device)
    zmin.scatter_reduce_(0, ti_safe, zs, "amin")
    winner = valid & (zs <= zmin[ti_safe] * (1.0 + 1e-5))
    # Only winners carry weight; the reference adds zeros for the rest.
    # Leaving them out keeps every sum and avoids one huge run of
    # invalid sources at index 0 in the sorted scatter-add.
    idx = ti_safe[winner]
    cnt = scatter_add(size, idx, torch.ones_like(idx, dtype=torch.float32))
    acc = scatter_add(size, idx, values[winner])
    hit = cnt > 0
    out = acc / torch.clamp_min(cnt, 1.0)[:, None]
    return torch.where(hit, zmin, 0.0), out, hit


def _project_points(ref_cam: Camera, depth_map: torch.Tensor,
                    mask: torch.Tensor, tgt_cam: Camera, near: float):
    """Back-project ``depth_map`` and reproject into the target view.

    Returns (ti, z, valid): (S,) flat target pixel index, target-view
    depth, and source validity (mask & in front & in bounds).
    """
    h, w = depth_map.shape
    pts = backproject(ref_cam, depth_map)                   # (H, W, 3)
    rot, t = tgt_cam.w2c[:3, :3], tgt_cam.w2c[:3, 3]
    pc = pts.reshape(-1, 3) @ rot.T + t
    z = pc[:, 2]
    u = tgt_cam.fx * pc[:, 0] / torch.clamp_min(z, near) + tgt_cam.cx
    v = tgt_cam.fy * pc[:, 1] / torch.clamp_min(z, near) + tgt_cam.cy
    ui = torch.floor(u).to(torch.int32)
    vi = torch.floor(v).to(torch.int32)
    in_bounds = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    valid = mask.reshape(-1) & (z > near) & in_bounds
    return vi * w + ui, z, valid


def viewpoint_transform(ref_rgb: torch.Tensor, ref_exp_depth: torch.Tensor,
                        ref_trunc_depth: torch.Tensor,
                        ref_source_mask: torch.Tensor,
                        ref_cam: Camera, tgt_cam: Camera, *,
                        n0_ratio: float = N0_RATIO,
                        near: float = 0.05) -> WarpResult:
    """Algorithm 1 (viewpoint transformation + tile decisions)."""
    h, w = ref_rgb.shape[:2]
    size = h * w

    ti, z, src_valid = _project_points(ref_cam, ref_exp_depth,
                                       ref_source_mask, tgt_cam, near)
    # Reprojected scene depth = *target-view* z of the winning source.
    zmap, out, hit = _scatter_zbuffer(ti, z, src_valid,
                                      ref_rgb.reshape(-1, 3), size)
    rgb_t = out.reshape(h, w, 3)
    filled = hit.reshape(h, w)
    exp_depth_t = zmap.reshape(h, w)

    # Truncated-depth point cloud (separate cloud, max-scatter).
    tim_raw, zm, mvalid = _project_points(ref_cam, ref_trunc_depth,
                                          ref_source_mask, tgt_cam, near)
    tim = torch.where(mvalid, tim_raw, 0).long()
    trunc_t = torch.zeros((size,), dtype=torch.float32, device=zm.device)
    trunc_t.scatter_reduce_(0, tim, torch.where(mvalid, zm, 0.0), "amax")
    trunc_t = trunc_t.reshape(h, w)

    # Per-tile decisions (Algo. 1 lines 5-12).
    tx, ty = tgt_cam.tiles_x, tgt_cam.tiles_y
    filled_tiles = tile_view(filled[..., None].to(torch.int32), tx, ty)
    valid_per_tile = filled_tiles.sum(dim=(1, 2, 3), dtype=torch.int32)
    n0 = int(round(n0_ratio * TILE * TILE))
    interpolate_tile = valid_per_tile > n0
    rerender_tile = ~interpolate_tile

    # DPES: early-stop depth = max reprojected truncated depth over the
    # tile's valid pixels; unusable (inf) when nothing valid arrived.
    trunc_tiles = tile_view(trunc_t[..., None], tx, ty)[..., 0]
    tile_max_trunc = trunc_tiles.amax(dim=(1, 2))
    inf = torch.full_like(tile_max_trunc, float("inf"))
    dpes_depth = torch.where(valid_per_tile > 0, tile_max_trunc, inf)
    dpes_depth = torch.where(tile_max_trunc > 0, dpes_depth, inf)

    return WarpResult(rgb=rgb_t, filled=filled, exp_depth=exp_depth_t,
                      trunc_depth=trunc_t, valid_per_tile=valid_per_tile,
                      interpolate_tile=interpolate_tile,
                      rerender_tile=rerender_tile, dpes_depth=dpes_depth)


def inpaint(rgb: torch.Tensor, filled: torch.Tensor, *,
            iters: int = 8) -> torch.Tensor:
    """Fill holes by iterative 3x3 neighbour averaging (Jacobi diffusion).

    Only missing pixels are written; valid pixels are fixed boundary
    conditions.
    """
    f = filled.to(torch.float32)[..., None]
    img = rgb * f

    def blur(x):
        # (H, W, C) -> same, 3x3 box sum with zero padding.
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        return (xp[:-2, :-2] + xp[:-2, 1:-1] + xp[:-2, 2:]
                + xp[1:-1, :-2] + xp[1:-1, 1:-1] + xp[1:-1, 2:]
                + xp[2:, :-2] + xp[2:, 1:-1] + xp[2:, 2:])

    wgt = f
    for _ in range(iters):
        num = blur(img * wgt)
        den = blur(wgt)
        fill_val = num / torch.clamp_min(den, 1e-8)
        img = torch.where(filled[..., None], rgb, fill_val)
        wgt = torch.maximum(wgt, (den[..., :1] > 0).to(torch.float32))
    return img


def pixel_warp_fill(warp: WarpResult, full_rgb: torch.Tensor) -> torch.Tensor:
    """PWSR baseline (Potamoi-style): keep every warped pixel, fill only the
    missing ones with freshly rendered values. Quality-only baseline for
    the paper's Fig. 7 — it still pays full preprocess + sort."""
    return torch.where(warp.filled[..., None], warp.rgb, full_rgb)
