"""Sparse TAIT intersect and per-slot K-nearest binning: a CUDA kernel and
its plain version.

Replaces no TPU kernel: the reference computes this layer as plain jnp,
the TAIT masks of ``repro/core/intersect.py`` over every (Gaussian, plan
slot) pair and ``repro/core/binning.py::build_tile_bins``'s ``lax.top_k``
over all N Gaussians a slot. Here each Gaussian lists only the tiles its
tight box touches, and each slot sorts only the pairs that reached it.
Both versions return exactly what the dense path returns (TAIT masks,
``culling.cull_pairs``, ``binning.build_tile_bins`` over the plan's
active slots), lane for lane:

- ``intersect_pairs`` gives each active slot's pairs after the cull and
  the DPES limit as the binning's keys, ``(order bits of depth << 32) |
  id``, grouped by slot (``SlotPairs``), with the stage-1 and culled
  totals, ``raw_slots`` and the slots' flags after the cull;
- ``select_bins`` keeps each slot's K = min(capacity, N) smallest keys in
  order. Lanes past a slot's count hold the smallest ids outside its set,
  ascending, as top-k of the masked row gives them.

CPU tensors take the plain version (tile ranges by ``repeat_interleave``,
the same predicates as ``core/intersect.py``, a stable sort by slot and
key, the first K a slot); it runs on CUDA tensors too when called by
name (``intersect_pairs_torch``, ``select_bins_torch``). CUDA tensors
launch ``csrc/intersect_bin.cu`` (or raise): ``intersect_pairs`` launches
its map, count and scan kernels, reads the pair total once (the host's
one wait a call), then launches the emit kernel; ``select_bins`` launches
the select kernel. Each kernel adds one to
``kernel_launches_total{kernel="intersect_bin"}`` (five a call pair), and
``intersect_pairs`` adds the pair total to ``intersect_pairs_total`` on
either device. What bounds the kernel, and its design, is in the source.
"""
from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.binning import TileBins, _ordered_bits
from repro_torch.core.camera import TILE
from repro_torch.core.intersect import TILE_CIRCUMRADIUS, TileGrid
from repro_torch.core.projection import ProjectedGaussians
from repro_torch.kernels import _build
from repro_torch.obs.metrics import PROCESS_METRICS, kernel_launches

_LAUNCHES = kernel_launches("intersect_bin")
_PAIRS = PROCESS_METRICS.counter(
    "intersect_pairs_total",
    "Gaussian-slot pairs the sparse intersect carried to the selection "
    "(after the cull and the DPES limit, before the K cut)")

# The kernel sorts a slot's selected keys in one CTA: K up to 4,096.
MAX_K = 4096


class SlotPairs(NamedTuple):
    """Each active slot's pairs after the cull and the DPES limit, and the
    counters of the plan's slots."""

    keys: torch.Tensor             # (P,) int64 binning keys, grouped by slot
    offsets: torch.Tensor          # (R + 1,) int64 segment starts; [R] = P
    count_full: torch.Tensor       # (R,) int32 pairs in each segment
    candidate_pairs: torch.Tensor  # () int32 stage-1 pairs, active slots
    raw_slots: torch.Tensor        # (R,) int32 pairs after the cull
    culled_pairs: torch.Tensor     # () int32 pairs the cull removed
    slot_active: torch.Tensor      # (R,) bool, fully culled slots demoted
    n: int                         # Gaussians (K = min(capacity, n))


def workspace_words(tiles: int, r: int) -> int:
    """int32 words of the kernel's zeroed workspace (``Workspace`` in the
    source): the tile -> slot map, four per-slot counters, two totals."""
    return tiles + 4 * r + 2


def _check_inputs(proj: ProjectedGaussians, grid: TileGrid,
                  tile_ids: torch.Tensor, slot_active: torch.Tensor,
                  limit: Optional[torch.Tensor],
                  cull: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    n, r, t = proj.depth.shape[0], tile_ids.shape[0], grid.num_tiles
    want = {"mean2d": (proj.mean2d, torch.float32, (n, 2)),
            "tight_half_wh": (proj.tight_half_wh, torch.float32, (n, 2)),
            "minor_axis": (proj.minor_axis, torch.float32, (n, 2)),
            "r_minor": (proj.r_minor, torch.float32, (n,)),
            "depth": (proj.depth, torch.float32, (n,)),
            "valid": (proj.valid, torch.bool, (n,)),
            "tile_ids": (tile_ids, torch.int32, (r,)),
            "slot_active": (slot_active, torch.bool, (r,))}
    if limit is not None:
        want["limit"] = (limit, torch.float32, (r,))
    if cull is not None:
        want["keep"] = (cull[0], torch.bool, (n,))
        want["gate"] = (cull[1], torch.bool, (t,))
    dev = proj.depth.device
    for name, (x, dtype, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, depth on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")


# --- plain version ---------------------------------------------------------

def _slot_of_tile(tile_ids, slot_active, tiles: int) -> torch.Tensor:
    """(T,) int64: the active slot holding each tile, -1 for none (a plan
    holds a tile at most once)."""
    r = tile_ids.shape[0]
    slot = torch.where(slot_active,
                       torch.arange(r, device=tile_ids.device), -1)
    out = torch.full((tiles,), -1, dtype=torch.int64, device=tile_ids.device)
    out[tile_ids.long()] = slot
    return out


def _box_tiles(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor,
               grid: TileGrid):
    """Every (Gaussian, tile) of each valid Gaussian's tile range: x in
    [floor(lo / 16), floor(hi / 16)] and y alike, clamped to the grid,
    where lo, hi (N, 2) = mean -/+ the tight half extents. Stage 1 holds
    on no tile outside it. Returns (gaussian ids, tile ids), both int64."""
    top = torch.tensor([grid.tiles_x - 1, grid.tiles_y - 1],
                       dtype=torch.float32, device=lo.device)
    first = torch.clamp_min(torch.floor(lo * (1.0 / TILE)), 0.0)
    last = torch.minimum(torch.floor(hi * (1.0 / TILE)), top)
    live = valid & (last >= first).all(dim=1)   # NaN fails too
    first = torch.where(live[:, None], first, 0.0).long()
    span = torch.where(live[:, None], last, -1.0).long() - first + 1
    area = span[:, 0] * span[:, 1]
    g = torch.repeat_interleave(
        torch.arange(area.shape[0], device=area.device), area)
    local = torch.arange(g.shape[0], device=g.device) \
        - (torch.cumsum(area, 0) - area)[g]
    tx = first[g, 0] + local % span[g, 0]
    ty = first[g, 1] + local // span[g, 0]
    return g, ty * grid.tiles_x + tx


def intersect_pairs_torch(proj: ProjectedGaussians, grid: TileGrid,
                          tile_ids: torch.Tensor, slot_active: torch.Tensor,
                          limit: Optional[torch.Tensor] = None,
                          cull: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                          ) -> SlotPairs:
    """Plain version of ``intersect_pairs`` (any device)."""
    _check_inputs(proj, grid, tile_ids, slot_active, limit, cull)
    n, r = proj.depth.shape[0], tile_ids.shape[0]
    i32 = torch.int32
    lo = proj.mean2d - proj.tight_half_wh
    hi = proj.mean2d + proj.tight_half_wh
    g, t = _box_tiles(lo, hi, proj.valid, grid)
    s = _slot_of_tile(tile_ids, slot_active, grid.num_tiles)[t]
    on = s >= 0
    g, t, s = g[on], t[on], s[on]
    # Stage 1 and stage 2 as core/intersect.py computes them, pair by pair.
    t_lo = grid.origins[t]
    t_hi = t_lo + TILE
    stage1 = ((lo[g, 0] < t_hi[:, 0]) & (hi[g, 0] > t_lo[:, 0])
              & (lo[g, 1] < t_hi[:, 1]) & (hi[g, 1] > t_lo[:, 1]))
    candidate_pairs = stage1.sum(dtype=i32)
    d = grid.centers[t] - proj.mean2d[g]
    axis = proj.minor_axis[g]
    along = d[:, 0] * axis[:, 0] + d[:, 1] * axis[:, 1]
    mask = stage1 & (along.abs() - TILE_CIRCUMRADIUS <= proj.r_minor[g])
    culled_pairs = torch.zeros((), dtype=i32, device=g.device)
    active = slot_active
    if cull is not None:
        pre = torch.bincount(s[mask], minlength=r)
        mask = mask & (cull[0][g] | ~cull[1][t])
        post = torch.bincount(s[mask], minlength=r)
        culled_pairs = (pre - post).sum().to(i32)
        active = slot_active & ~((pre > 0) & (post == 0))
    raw_slots = torch.bincount(s[mask], minlength=r).to(i32)
    if limit is not None:
        mask = mask & (proj.depth[g] <= limit[s])
    g, s = g[mask], s[mask]
    count_full = torch.bincount(s, minlength=r)
    order = torch.argsort(s, stable=True)
    keys = (_ordered_bits(proj.depth[g]) << 32) | g
    offsets = torch.cat([count_full.new_zeros(1), torch.cumsum(count_full,
                                                               0)])
    return SlotPairs(keys=keys[order], offsets=offsets,
                     count_full=count_full.to(i32),
                     candidate_pairs=candidate_pairs, raw_slots=raw_slots,
                     culled_pairs=culled_pairs, slot_active=active, n=n)


def select_bins_torch(pairs: SlotPairs, capacity: int) -> TileBins:
    """Plain version of ``select_bins`` (any device)."""
    r, n = pairs.count_full.shape[0], pairs.n
    k = min(capacity, n)
    dev = pairs.keys.device
    count = pairs.count_full.long()
    slot = torch.repeat_interleave(torch.arange(r, device=dev), count)
    by_key = torch.argsort(pairs.keys, stable=True)
    order = by_key[torch.argsort(slot[by_key], stable=True)]
    key, slot = pairs.keys[order], slot[order]
    rank = torch.arange(key.shape[0], device=dev) - pairs.offsets[slot]
    keep = rank < k
    indices = torch.zeros((r, k), dtype=torch.int32, device=dev)
    valid = torch.zeros((r, k), dtype=torch.bool, device=dev)
    indices[slot[keep], rank[keep]] = (key[keep] & 0xFFFFFFFF).to(
        torch.int32)
    valid[slot[keep], rank[keep]] = True
    # Lanes count .. K-1: the smallest ids outside the slot's set; with
    # fewer than K members they all lie below K + count < 2K.
    ids = min(2 * k, n)
    member = torch.zeros((r, ids), dtype=torch.bool, device=dev)
    gid = key & 0xFFFFFFFF
    low = gid < ids
    member[slot[low], gid[low]] = True
    free = ~member
    lane = count[:, None] + torch.cumsum(free, dim=1) - 1
    fill = free & (lane < k)
    rows, cols = torch.nonzero(fill, as_tuple=True)
    indices[rows, lane[rows, cols]] = cols.to(torch.int32)
    return TileBins(indices=indices, valid=valid,
                    count=torch.clamp_max(pairs.count_full, capacity),
                    overflow=torch.clamp_min(pairs.count_full - capacity, 0),
                    capacity=capacity)


# --- CUDA kernel ---------------------------------------------------------

class Pairs(ctypes.Structure):
    """The count and emit passes' inputs (``IntersectPairs`` in
    csrc/intersect_bin.cu); a null pointer leaves out the cull or the
    limit."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "mean2d", "half_wh", "minor_axis", "r_minor", "depth", "valid",
        "keep", "gate", "limit", "tile_ids", "slot_active")] + [
        (name, ctypes.c_int) for name in ("n", "tiles_x", "tiles_y", "r")] \
        + [("circumradius", ctypes.c_float)]


def _c_functions():
    lib = _build.load_library("intersect_bin")
    count, emit, select = (lib.intersect_bin_count, lib.intersect_bin_emit,
                           lib.intersect_bin_select)
    if count.argtypes is None:
        count.argtypes = [Pairs] + [ctypes.c_void_p] * 4
        emit.argtypes = [Pairs] + [ctypes.c_void_p] * 4
        select.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 5
        for fn in (count, emit, select):
            fn.restype = ctypes.c_int
    return count, emit, select


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check_cuda(named) -> None:
    for name, x in named.items():
        if x is None:
            continue
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device.type != "cuda":
            raise ValueError(f"the intersect_bin kernel needs CUDA tensors; "
                             f"{name} is on {x.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"intersect_bin {what} launch failed: CUDA error "
                           f"{err}")


def intersect_pairs_cuda(proj: ProjectedGaussians, grid: TileGrid,
                         tile_ids: torch.Tensor, slot_active: torch.Tensor,
                         limit: Optional[torch.Tensor] = None,
                         cull: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None
                         ) -> SlotPairs:
    """Launch the map, count, scan and emit kernels (no counting)."""
    _check_inputs(proj, grid, tile_ids, slot_active, limit, cull)
    keep, gate = (None, None) if cull is None else cull
    _check_cuda(dict(mean2d=proj.mean2d, tight_half_wh=proj.tight_half_wh,
                     minor_axis=proj.minor_axis, r_minor=proj.r_minor,
                     depth=proj.depth, valid=proj.valid, tile_ids=tile_ids,
                     slot_active=slot_active, limit=limit, keep=keep,
                     gate=gate))
    n, r, tiles = proj.depth.shape[0], tile_ids.shape[0], grid.num_tiles
    dev = proj.depth.device
    ws = torch.zeros((workspace_words(tiles, r),), dtype=torch.int32,
                     device=dev)
    offsets = torch.empty((r + 1,), dtype=torch.int64, device=dev)
    active = torch.empty((r,), dtype=torch.bool, device=dev)
    p = Pairs(*(_ptr(x) for x in (
        proj.mean2d, proj.tight_half_wh, proj.minor_axis, proj.r_minor,
        proj.depth, proj.valid, keep, gate, limit, tile_ids, slot_active)),
        n, grid.tiles_x, grid.tiles_y, r, TILE_CIRCUMRADIUS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    count, emit, _ = _c_functions()
    _raise_on(count(p, ws.data_ptr(), offsets.data_ptr(),
                    active.data_ptr(), stream), "count")
    total = int(offsets[r])   # the pair total: the call's one host wait
    keys = torch.empty((total,), dtype=torch.int64, device=dev)
    _raise_on(emit(p, ws.data_ptr(), offsets.data_ptr(), keys.data_ptr(),
                   stream), "emit")
    return SlotPairs(keys=keys, offsets=offsets,
                     count_full=ws[tiles + r:tiles + 2 * r],
                     candidate_pairs=ws[tiles + 4 * r],
                     raw_slots=ws[tiles:tiles + r],
                     culled_pairs=ws[tiles + 4 * r + 1], slot_active=active,
                     n=n)


def select_bins_cuda(pairs: SlotPairs, capacity: int) -> TileBins:
    """Launch the select kernel (no counting)."""
    r, k = pairs.count_full.shape[0], min(capacity, pairs.n)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K = min(capacity, N) = {k}: the select kernel "
                         f"takes 1 to {MAX_K}")
    if pairs.count_full.dtype != torch.int32:
        raise TypeError(f"count_full must be int32, got "
                        f"{pairs.count_full.dtype}")
    _check_cuda(dict(keys=pairs.keys, offsets=pairs.offsets,
                     count_full=pairs.count_full))
    dev = pairs.keys.device
    indices = torch.empty((r, k), dtype=torch.int32, device=dev)
    valid = torch.empty((r, k), dtype=torch.bool, device=dev)
    count = torch.empty((r,), dtype=torch.int32, device=dev)
    overflow = torch.empty((r,), dtype=torch.int32, device=dev)
    _, _, select = _c_functions()
    _raise_on(select(pairs.keys.data_ptr(), pairs.offsets.data_ptr(),
                     pairs.count_full.data_ptr(), r, k, capacity,
                     indices.data_ptr(), valid.data_ptr(), count.data_ptr(),
                     overflow.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream), "select")
    return TileBins(indices=indices, valid=valid, count=count,
                    overflow=overflow, capacity=capacity)


# --- wrappers --------------------------------------------------------------

def intersect_pairs(proj: ProjectedGaussians, grid: TileGrid,
                    tile_ids: torch.Tensor, slot_active: torch.Tensor,
                    limit: Optional[torch.Tensor] = None,
                    cull: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> SlotPairs:
    """TAIT pairs of the plan's active slots (``tile_ids`` (R,) int32,
    each tile at most once; ``slot_active`` (R,) bool) on ``grid``, after
    the cull and the DPES limit.

    ``limit``: (R,) float32 DPES depth limit, or None. ``cull``: (keep,
    gate), keep (N,) bool = prior >= threshold and gate (T,) bool, or None
    for no cull: a pair is culled where its Gaussian is not kept and its
    tile's gate is on, and a slot that loses all its pairs is demoted.
    """
    if proj.depth.device.type == "cpu":
        out = intersect_pairs_torch(proj, grid, tile_ids, slot_active, limit,
                                    cull)
    else:
        out = intersect_pairs_cuda(proj, grid, tile_ids, slot_active, limit,
                                   cull)
        _LAUNCHES.inc(4)
    _PAIRS.inc(out.keys.shape[0])
    return out


def select_bins(pairs: SlotPairs, capacity: int) -> TileBins:
    """(R, K) bins of each slot's K = min(capacity, N) nearest pairs, in
    (depth, id) order, with count = min(pairs, capacity) and the
    overflow: what ``binning.build_tile_bins`` gives on the dense mask."""
    if pairs.keys.device.type == "cpu":
        return select_bins_torch(pairs, capacity)
    out = select_bins_cuda(pairs, capacity)
    _LAUNCHES.inc()
    return out


def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("intersect_bin")
    _build.load_library.cache_clear()
    _build.load_library("intersect_bin")
    return time.perf_counter() - t0, report
