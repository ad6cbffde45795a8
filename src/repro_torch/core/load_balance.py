"""LDU — Load Distribution Unit scheduling (port of the device half of
``repro/core/load_balance.py``, paper Sec. V-B).

Assigns plan slots to B parallel raster blocks. The paper's policy
("ls_gaussian"): visit tiles in Morton order; a tile joins the current
block unless that would push the block past ``(1 + 1/N) * W`` (W = ideal
per-block load, N = average tiles per block), then defers cyclically to
the next block with room (least-loaded as the fallback); inside a block,
tiles run light to heavy. Baselines: "static_blocked", "round_robin",
"dynamic" (greedy shortest queue).

The greedy fills are sequential scans. They run on the host over a copy
of the (R,) workload — one small transfer per frame instead of R tiny
device launches — with float32 accumulators exactly as the reference's
``lax.scan`` keeps them, so the assignments agree bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A tile -> block schedule on the host (the accelerator simulator's
    input, core/streaming.py)."""

    block_of_tile: np.ndarray   # (T,) block id per tile (-1 = not scheduled)
    order_in_block: np.ndarray  # (T,) execution position within its block
    num_blocks: int

    def tiles_of_block(self, b: int) -> np.ndarray:
        ids = np.where(self.block_of_tile == b)[0]
        return ids[np.argsort(self.order_in_block[ids], kind="stable")]


def morton_rank(tiles_x: int, tiles_y: int, *, device="cuda") -> torch.Tensor:
    """(T,) int32 Z-order visit priority per tile id.

    ``rank[tid]`` is the position of tile ``tid`` along the Morton curve,
    so ``argsort(rank)`` is the Morton traversal.
    """
    def interleave(x: torch.Tensor) -> torch.Tensor:
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    dev = resolve_device(device)
    ty, tx = torch.meshgrid(torch.arange(tiles_y, device=dev),
                            torch.arange(tiles_x, device=dev), indexing="ij")
    code = interleave(tx.reshape(-1)) | (interleave(ty.reshape(-1)) << 1)
    order = torch.argsort(code, stable=True)
    t = tiles_x * tiles_y
    rank = torch.empty((t,), dtype=torch.int32, device=dev)
    rank[order] = torch.arange(t, dtype=torch.int32, device=dev)
    return rank


def greedy_fill(workload: torch.Tensor, active: torch.Tensor,
                num_blocks: int) -> torch.Tensor:
    """Paper's greedy capacity fill over slots IN ORDER (host scan).

    workload: (R,) predicted pairs; active: (R,) bool. Inactive slots are
    skipped and get block -1. Returns (R,) int32 on the input's device.
    """
    b = max(int(num_blocks), 1)
    f32 = np.float32
    # The reference's int32 entry cast, then float32 like its scan.
    wl = workload.to(torch.int32).cpu().numpy().astype(f32)
    act = active.to(torch.bool).cpu().numpy()
    total = f32(wl[act].astype(np.float64).sum())
    w_ideal = max(total / f32(b), f32(1.0))
    n_avg = max(f32(act.sum()) / f32(b), f32(1.0))
    cap = (f32(1.0) + f32(1.0) / n_avg) * w_ideal
    accs = np.zeros((b,), f32)
    out = np.full(wl.shape, -1, np.int32)
    cur = 0
    for i in np.flatnonzero(act):
        w = wl[i]
        if accs[cur] + w > cap:
            cand = (cur + 1 + np.arange(b)) % b
            fits = accs[cand] + w <= cap
            cur = int(cand[np.argmax(fits)]) if fits.any() \
                else int(np.argmin(accs))
        accs[cur] += w
        out[i] = cur
    return torch.from_numpy(out).to(workload.device)


def order_within_blocks(block_of: torch.Tensor, key: torch.Tensor,
                        tiebreak: torch.Tensor) -> torch.Tensor:
    """(R,) execution position of each slot within its block.

    ``key`` is the primary ordering (workload for light-to-heavy, visit
    position for arrival order); ties break on ``tiebreak`` (tile id).
    Slots with block -1 get position 0.
    """
    r = block_of.shape[0]
    # lexsort((tiebreak, key, block_of)) as successive stable sorts.
    idx = torch.argsort(tiebreak, stable=True)
    idx = idx[torch.argsort(key[idx], stable=True)]
    idx = idx[torch.argsort(block_of[idx], stable=True)]
    blk_sorted = block_of[idx]
    pos = torch.arange(r, dtype=torch.int32, device=block_of.device)
    is_start = torch.ones((r,), dtype=torch.bool, device=block_of.device)
    is_start[1:] = blk_sorted[1:] != blk_sorted[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    order = torch.empty((r,), dtype=torch.int32, device=block_of.device)
    order[idx] = pos - seg_start
    return torch.where(block_of >= 0, order, 0)


def _dynamic_fill(workload: torch.Tensor, active: torch.Tensor,
                  b: int) -> torch.Tensor:
    """GPU-scheduler model: next active tile to the least-loaded block."""
    wl = workload.cpu().numpy().astype(np.float32)
    act = active.cpu().numpy()
    loads = np.zeros((b,), np.float32)
    out = np.full(wl.shape, -1, np.int32)
    for i in np.flatnonzero(act):
        j = int(np.argmin(loads))
        loads[j] += wl[i]
        out[i] = j
    return torch.from_numpy(out).to(workload.device)


def ldu_schedule(workload: torch.Tensor, num_blocks: int, *,
                 policy: str = "ls_gaussian",
                 tiles_x: Optional[int] = None,
                 tiles_y: Optional[int] = None,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile -> block schedule; returns ``(block_of_tile, order_in_block)``,
    both (T,) int32, equal to the reference's ``ldu_schedule``."""
    workload = workload.to(torch.int32)
    dev = workload.device
    t = workload.shape[0]
    b = max(int(num_blocks), 1)
    if active is None:
        active = torch.ones((t,), dtype=torch.bool, device=dev)
    active = active.to(torch.bool)
    tile_ids = torch.arange(t, dtype=torch.int32, device=dev)
    pos_active = torch.cumsum(active.to(torch.int32), 0, dtype=torch.int32) - 1
    n_active = int(active.sum())

    if policy == "static_blocked":
        chunk = max((n_active + b - 1) // b, 1)
        blk = torch.clamp_max(pos_active // chunk, b - 1)
        block_of = torch.where(active, blk, -1).to(torch.int32)
    elif policy == "round_robin":
        block_of = torch.where(active, pos_active % b, -1).to(torch.int32)
    elif policy == "dynamic":
        block_of = _dynamic_fill(workload, active, b)
    elif policy == "ls_gaussian":
        if tiles_x is None or tiles_y is None:
            raise ValueError("ls_gaussian policy needs tiles_x/tiles_y for "
                             "Morton traversal")
        visit = torch.argsort(morton_rank(tiles_x, tiles_y, device=dev),
                              stable=True)
        blk_v = greedy_fill(workload[visit], active[visit], b)
        block_of = torch.full((t,), -1, dtype=torch.int32, device=dev)
        block_of[visit] = blk_v
    else:
        raise ValueError(f"unknown policy {policy!r}")

    key = workload if policy == "ls_gaussian" else tile_ids
    return block_of, order_within_blocks(block_of, key, tile_ids)
