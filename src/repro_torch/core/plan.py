"""TilePlan — the compacted per-frame render plan (port of
``repro/core/plan.py``; the contract is DESIGN.md §2).

  tile_ids       (R,) int32  tile ids in Morton visit order, active first
  slot_active    (R,) bool   padded slots are inactive, contribute nothing
  workload       (R,) int32  DPES-predicted pairs per slot (after binning)
  block_of       (R,) int32  LDU block assignment (-1 inactive)
  order_in_block (R,) int32  light-to-heavy execution position
  overflow_tiles ()   int32  re-render tiles dropped because R was full

Key frames carry an all-tiles plan (R = T); TWSR sparse frames carry the
warp-predicted re-render set compacted to ``R = rerender_capacity``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import load_balance


class TilePlan(NamedTuple):
    """Compacted frame plan; see module docstring for the field contract."""

    tile_ids: torch.Tensor        # (R,) int32
    slot_active: torch.Tensor     # (R,) bool
    workload: torch.Tensor        # (R,) int32
    block_of: torch.Tensor        # (R,) int32
    order_in_block: torch.Tensor  # (R,) int32
    overflow_tiles: torch.Tensor  # () int32

    @property
    def num_slots(self) -> int:
        return self.tile_ids.shape[0]


def _blank(tile_ids: torch.Tensor, slot_active: torch.Tensor,
           overflow_tiles: torch.Tensor) -> TilePlan:
    r = tile_ids.shape[0]
    i32 = dict(dtype=torch.int32, device=tile_ids.device)
    return TilePlan(
        tile_ids=tile_ids.to(torch.int32), slot_active=slot_active,
        workload=torch.zeros((r,), **i32),
        block_of=torch.full((r,), -1, **i32),
        order_in_block=torch.zeros((r,), **i32),
        overflow_tiles=overflow_tiles.to(torch.int32))


def full_plan(tiles_x: int, tiles_y: int, *, device="cuda") -> TilePlan:
    """All-tiles plan (R = T) in Morton visit order — key frames."""
    visit = torch.argsort(load_balance.morton_rank(tiles_x, tiles_y,
                                                   device=device), stable=True)
    t = tiles_x * tiles_y
    dev = visit.device
    return _blank(visit, torch.ones((t,), dtype=torch.bool, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev))


def sparse_plan(rerender: torch.Tensor, tiles_x: int, tiles_y: int,
                capacity: Optional[int]) -> TilePlan:
    """Compact the TWSR re-render set into R = ``capacity`` plan slots.

    Re-render tiles are taken in Morton order; with more re-render tiles
    than slots, the Morton tail overflows (counted, degrades to
    interpolation). ``capacity=None`` keeps R = T.
    """
    t = rerender.shape[0]
    r = t if capacity is None else min(int(capacity), t)
    rank = load_balance.morton_rank(tiles_x, tiles_y,
                                    device=rerender.device)
    # Active tiles first (in Morton order), inactive Morton-ordered after.
    ids = torch.argsort(torch.where(rerender, rank, t + rank),
                        stable=True)[:r]
    slot_active = rerender[ids]
    overflow = (rerender.sum(dtype=torch.int32)
                - slot_active.sum(dtype=torch.int32))
    return _blank(ids, slot_active, overflow)


def schedule_plan(plan: TilePlan, workload: torch.Tensor,
                  num_blocks: int) -> TilePlan:
    """Run the LDU over the plan's slots (paper Sec. V-B).

    Slots are already in Morton visit order, so the greedy capacity fill
    scans them directly; intra-block order is light-to-heavy with tile-id
    tie-breaks.
    """
    workload = workload.to(torch.int32)
    block_of = load_balance.greedy_fill(workload, plan.slot_active,
                                        num_blocks)
    order = load_balance.order_within_blocks(block_of, workload,
                                             plan.tile_ids)
    return plan._replace(workload=workload, block_of=block_of,
                         order_in_block=order)


def scatter_slots(plan: TilePlan, values: torch.Tensor, num_tiles: int,
                  fill=0) -> torch.Tensor:
    """(R, ...) per-slot values -> (T, ...) per-tile, ``fill`` elsewhere.

    Inactive slots are masked to ``fill`` so padded slots never leak
    stale values into the per-tile view.
    """
    active = plan.slot_active.reshape((-1,) + (1,) * (values.dim() - 1))
    out = torch.full((num_tiles,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[plan.tile_ids.long()] = torch.where(
        active, values, torch.full_like(values, fill))
    return out


def rerender_demand(active, overflow_tiles) -> torch.Tensor:
    """Per-frame re-render demand: tiles that won a slot plus the Morton
    tail that overflowed. Works on stacked ``(F, ..., T)`` records; the
    result is int32."""
    active = torch.as_tensor(active)
    overflow_tiles = torch.as_tensor(overflow_tiles, device=active.device)
    return (active.to(torch.int32).sum(dim=-1, dtype=torch.int32)
            + overflow_tiles.to(torch.int32))


def block_loads(plan: TilePlan, num_blocks: int) -> torch.Tensor:
    """(B,) predicted pairs per LDU block — the FrameRecord load summary."""
    idx = torch.where(plan.block_of >= 0, plan.block_of, num_blocks).long()
    wl = torch.where(plan.slot_active, plan.workload, 0)
    loads = torch.zeros((num_blocks + 1,), dtype=torch.int32,
                        device=wl.device)
    loads.index_add_(0, idx, wl)
    return loads[:num_blocks]
