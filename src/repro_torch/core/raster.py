"""Rasterization orchestrator: tiles in, full-frame images out (port of
``repro/core/raster.py``).

``render_plan_slots`` rasterizes only a TilePlan's R compacted slots and
scatters the tile images back into the full frame (untouched tiles read
as empty: rgb 0, T = 1). ``render_from_bins`` keeps the dense (T,) layout.
``render_oracle`` is the brute-force check of both: every pixel blends
every Gaussian in one global depth order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import binning
from repro_torch.core.camera import TILE, Camera
from repro_torch.core.intersect import TileGrid
from repro_torch.core.projection import ProjectedGaussians
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ALPHA_MAX, ALPHA_MIN, T_EPS


class RenderOutput(NamedTuple):
    rgb: torch.Tensor            # (H, W, 3)
    transmittance: torch.Tensor  # (H, W) final T per pixel
    exp_depth: torch.Tensor      # (H, W) opacity-weighted depth (Sec. IV-A)
    trunc_depth: torch.Tensor    # (H, W) early-stop depth (Sec. IV-B)
    processed_pairs: torch.Tensor  # (T,) pairs traversed per tile
    # Per (bin row, lane) sum of blend weights over the tile's pixels, in
    # bin lane order; rows follow the call's bin layout ((T, K) dense,
    # (R, K) plan slots). Per Gaussian: the same mass summed over the bin
    # indices.
    lane_contrib: torch.Tensor   # (rows, K) float32
    # (N,) float32; None from ``render_plan_slots(..., contrib=False)``.
    gauss_contrib: Optional[torch.Tensor]


def scatter_add(size: int, index: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """Deterministic ``zeros((size, ...)).at[index].add(values)``.

    Each device has one call that sums in element order, so that the
    result repeats bit for bit: on CUDA an accumulating ``index_put_``,
    which sorts the indices stably and sums each run of equal indices in
    order (``index_add_`` there adds with atomics); on the CPU
    ``index_add_``, which adds one element after another (an
    accumulating ``index_put_`` there adds large inputs with atomics).
    Neither depends on torch's global deterministic mode.
    """
    out = torch.zeros((size,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if out.is_cuda:
        return out.index_put_((index.long(),), values, accumulate=True)
    return out.index_add_(0, index.long(), values)


def untile(tiles: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(T, TILE, TILE, C?) -> (H, W, C?)."""
    extra = tuple(tiles.shape[3:])
    x = tiles.reshape(tiles_y, tiles_x, TILE, TILE, *extra)
    x = x.transpose(1, 2)
    return x.reshape(tiles_y * TILE, tiles_x * TILE, *extra)


def tile_view(img: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(H, W, C?) -> (T, TILE, TILE, C?). Inverse of ``untile``."""
    extra = tuple(img.shape[2:])
    x = img.reshape(tiles_y, TILE, tiles_x, TILE, *extra)
    x = x.transpose(1, 2)
    return x.reshape(tiles_y * tiles_x, TILE, TILE, *extra)


def _gauss_contrib(proj: ProjectedGaussians, bins: binning.TileBins,
                   lane_contrib: torch.Tensor) -> torch.Tensor:
    """(rows, K) per-lane contributions -> (N,) per-Gaussian totals.

    Invalid lanes contribute exactly 0 (their opacity is zeroed by
    ``gather_tiles``); they are left out so that their arbitrary indices
    form no long runs in the sorted scatter-add.
    """
    return scatter_add(proj.depth.shape[0], bins.indices[bins.valid],
                       lane_contrib[bins.valid])


def render_from_bins(proj: ProjectedGaussians, bins: binning.TileBins,
                     grid: TileGrid, *, impl: Optional[str] = None,
                     chunk: int = 64) -> RenderOutput:
    tg = binning.gather_tiles(proj, bins)
    rgb_t, trans_t, d_t, td_t, proc, contrib = kops.raster_tiles(
        tg.mean2d, tg.conic, tg.rgb, tg.opacity, tg.depth,
        grid.origins, bins.count, impl=impl, chunk=chunk)
    return RenderOutput(
        rgb=untile(rgb_t, grid.tiles_x, grid.tiles_y),
        transmittance=untile(trans_t, grid.tiles_x, grid.tiles_y),
        exp_depth=untile(d_t, grid.tiles_x, grid.tiles_y),
        trunc_depth=untile(td_t, grid.tiles_x, grid.tiles_y),
        processed_pairs=proc, lane_contrib=contrib,
        gauss_contrib=_gauss_contrib(proj, bins, contrib))


def render_plan_slots(proj: ProjectedGaussians, bins: binning.TileBins,
                      slot_origins: torch.Tensor, tile_ids: torch.Tensor,
                      grid: TileGrid, *, impl: Optional[str] = None,
                      chunk: int = 64,
                      slot_active: Optional[torch.Tensor] = None,
                      contrib: bool = True) -> RenderOutput:
    """Rasterize a TilePlan's R slots, scatter back to the (T,) frame.

    ``bins`` is the (R, K) compacted binning; ``slot_active`` is the
    plan's slot mask (the fused kernel skips masked slots). Tiles outside
    the plan read back as empty (rgb/depth 0, transmittance 1, 0 pairs).
    ``contrib=False`` skips the per-Gaussian scatter-add (a host sync and
    a sort over every valid pair) and leaves ``gauss_contrib`` None.
    """
    tg = binning.gather_tiles(proj, bins)
    rgb_s, trans_s, d_s, td_s, proc, contrib_s = kops.raster_tiles(
        tg.mean2d, tg.conic, tg.rgb, tg.opacity, tg.depth,
        slot_origins, bins.count, impl=impl, chunk=chunk,
        slot_active=slot_active)
    t = grid.num_tiles
    ids = tile_ids.long()
    f32 = dict(dtype=torch.float32, device=rgb_s.device)
    rgb_all = torch.zeros((t, TILE, TILE, 3), **f32)
    trans_all = torch.ones((t, TILE, TILE), **f32)
    d_all = torch.zeros((t, TILE, TILE), **f32)
    td_all = torch.zeros((t, TILE, TILE), **f32)
    proc_all = torch.zeros((t,), dtype=torch.int32, device=rgb_s.device)
    rgb_all[ids] = rgb_s
    trans_all[ids] = trans_s
    d_all[ids] = d_s
    td_all[ids] = td_s
    proc_all[ids] = proc
    return RenderOutput(
        rgb=untile(rgb_all, grid.tiles_x, grid.tiles_y),
        transmittance=untile(trans_all, grid.tiles_x, grid.tiles_y),
        exp_depth=untile(d_all, grid.tiles_x, grid.tiles_y),
        trunc_depth=untile(td_all, grid.tiles_x, grid.tiles_y),
        processed_pairs=proc_all, lane_contrib=contrib_s,
        gauss_contrib=_gauss_contrib(proj, bins, contrib_s) if contrib
        else None)


def render_oracle(proj: ProjectedGaussians, cam: Camera) -> RenderOutput:
    """Brute-force per-pixel blend over ALL Gaussians, depth-sorted globally.

    O(H*W*N), one Gaussian at a time — for small test scenes only.
    """
    n = proj.depth.shape[0]
    key = torch.where(proj.valid, proj.depth, float("inf"))
    order = torch.argsort(key, stable=True)
    opac = torch.where(proj.valid[order], proj.opacity[order], 0.0)
    dev = proj.depth.device
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.arange(cam.width, **f32) + 0.5
    v = torch.arange(cam.height, **f32) + 0.5
    py, px = torch.meshgrid(v, u, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    p = cam.width * cam.height
    color = torch.zeros((p, 3), **f32)
    trans = torch.ones((p,), **f32)
    done = torch.zeros((p,), dtype=torch.bool, device=dev)
    dacc = torch.zeros((p,), **f32)
    wacc = torch.zeros((p,), **f32)
    tdepth = torch.zeros((p,), **f32)
    for m, con, c, o, d in zip(proj.mean2d[order], proj.conic[order],
                               proj.rgb[order], opac, proj.depth[order]):
        dx = px - m[0]
        dy = py - m[1]
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) \
            - con[1] * dx * dy
        alpha = torch.clamp_max(o * torch.exp(power), ALPHA_MAX)
        alpha = torch.where(alpha >= ALPHA_MIN, alpha, 0.0)
        test_t = trans * (1.0 - alpha)
        trigger = (alpha > 0.0) & (test_t < T_EPS)   # sticky done (CUDA)
        blend = (alpha > 0.0) & ~done & ~trigger
        w = torch.where(blend, alpha * trans, 0.0)
        color = color + w[:, None] * c[None, :]
        dacc = dacc + w * d
        wacc = wacc + w
        tdepth = torch.where(blend, torch.maximum(tdepth, d), tdepth)
        trans = torch.where(blend, test_t, trans)
        done = done | trigger
    h, w = cam.height, cam.width
    n_tiles = (h // TILE) * (w // TILE)
    return RenderOutput(
        rgb=color.reshape(h, w, 3), transmittance=trans.reshape(h, w),
        exp_depth=(dacc / torch.clamp_min(wacc, 1e-8)).reshape(h, w),
        trunc_depth=tdepth.reshape(h, w),
        processed_pairs=torch.zeros((n_tiles,), dtype=torch.int32,
                                    device=dev),
        lane_contrib=torch.zeros((n_tiles, 1), **f32),
        gauss_contrib=torch.zeros((n,), **f32))
