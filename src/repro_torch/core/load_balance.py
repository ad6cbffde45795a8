"""LDU — Load Distribution Unit scheduling (port of
``repro/core/load_balance.py``, paper Sec. V-B).

Assigns tiles (plan slots) to B parallel raster blocks. The paper's
policy ("ls_gaussian"): visit tiles in Morton order; a tile joins the
current block unless that would push the block past ``(1 + 1/N) * W``
(W = ideal per-block load, N = average tiles per block), then defers
cyclically to the next block with room (least-loaded as the fallback);
inside a block, tiles run light to heavy. Baselines: "static_blocked",
"round_robin", "dynamic" (greedy shortest queue).

Two implementations live side by side, as in the reference:

- ``schedule`` (numpy, host): the golden reference with float64
  accumulators, used by the accelerator model's host policies
  (core/streaming.py).
- ``ldu_schedule`` / ``greedy_fill`` / ``order_within_blocks`` (torch,
  on the tensors' device): what the plan-driven renderer runs every
  frame (core/plan.py). The sequential fills run in the CUDA kernel
  ``kernels/ldu_fill.py`` on CUDA tensors (no host copy) and in its plain
  version, a numpy scan, on CPU tensors; both keep float32 accumulators
  as the reference's ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.ldu_fill import ldu_fill


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


def morton_order(tiles_x: int, tiles_y: int) -> np.ndarray:
    """Tile visit order following the Z-order curve. (T,) tile indices."""
    def interleave(x: np.ndarray) -> np.ndarray:
        x = x.astype(np.uint32)
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    ty, tx = np.meshgrid(np.arange(tiles_y), np.arange(tiles_x), indexing="ij")
    code = interleave(tx.ravel()) | (interleave(ty.ravel()) << 1)
    return np.argsort(code, kind="stable")


def golden_cap(workload: np.ndarray, num_blocks: int,
               active: np.ndarray) -> float:
    """The golden ``ls_gaussian`` fill's cap, in float64 as ``schedule``
    computes it: ``(1 + 1/n_avg) * w_ideal`` over the active tiles."""
    w = np.asarray(workload, np.int64)[np.asarray(active, bool)]
    b = max(num_blocks, 1)
    w_ideal = max(w.sum() / b, 1.0)
    n_avg = max(len(w) / b, 1.0)
    return float((1.0 + 1.0 / n_avg) * w_ideal)


def schedule(workload: np.ndarray, num_blocks: int, *,
             policy: str = "ls_gaussian",
             tiles_x: Optional[int] = None, tiles_y: Optional[int] = None,
             active: Optional[np.ndarray] = None) -> Schedule:
    """Build a tile->block schedule (numpy golden reference).

    workload: (T,) predicted pairs per tile (the LDU uses DPES estimates).
    active: optional (T,) bool — only these tiles are scheduled (TWSR
    re-render set); inactive tiles get block -1.
    """
    workload = np.asarray(workload, np.int64)
    t_total = workload.shape[0]
    if active is None:
        active = np.ones((t_total,), bool)
    active = np.asarray(active, bool)
    tile_ids = np.where(active)[0]
    t = len(tile_ids)
    block_of = np.full((t_total,), -1, np.int64)
    order_in = np.zeros((t_total,), np.int64)
    b = max(num_blocks, 1)

    if t == 0:
        return Schedule(block_of, order_in, b)

    if policy == "static_blocked":
        chunk = -(-t // b)
        for i, tid in enumerate(tile_ids):
            block_of[tid] = min(i // chunk, b - 1)
    elif policy == "round_robin":
        for i, tid in enumerate(tile_ids):
            block_of[tid] = i % b
    elif policy == "dynamic":
        # GPU-scheduler model: next tile (raster order) goes to the block
        # with the least accumulated work.
        loads = np.zeros(b)
        for tid in tile_ids:
            j = int(np.argmin(loads))
            block_of[tid] = j
            loads[j] += workload[tid]
    elif policy == "ls_gaussian":
        if tiles_x is None or tiles_y is None:
            raise ValueError("ls_gaussian policy needs tiles_x/tiles_y for "
                             "Morton traversal")
        visit = morton_order(tiles_x, tiles_y)
        visit = visit[active[visit]]
        cap = golden_cap(workload, b, active)
        # The paper defers a tile that would pass the cap to the next
        # block; deferring cyclically (next block with room, least-loaded
        # as the final fallback) keeps a fragmented traversal's overflow
        # out of the last block (the reference's DESIGN.md §3).
        accs = np.zeros(b)
        cur = 0
        for tid in visit:
            wl = float(workload[tid])
            if accs[cur] + wl > cap:
                for _ in range(b):
                    cur = (cur + 1) % b
                    if accs[cur] + wl <= cap:
                        break
                else:
                    cur = int(np.argmin(accs))
            block_of[tid] = cur
            accs[cur] += wl
    else:
        raise ValueError(f"unknown policy {policy!r}")

    # Intra-block execution order: the paper's light-to-heavy for
    # ls_gaussian, arrival order otherwise.
    for j in range(b):
        ids = np.where(block_of == j)[0]
        if len(ids) == 0:
            continue
        if policy == "ls_gaussian":
            perm = ids[np.argsort(workload[ids], kind="stable")]
        else:
            perm = ids
        order_in[perm] = np.arange(len(perm))
    return Schedule(block_of, order_in, b)


def load_stats(sched: Schedule, workload: np.ndarray) -> dict:
    """Imbalance diagnostics: per-block totals, max/mean ratio."""
    loads = np.zeros(sched.num_blocks)
    for j in range(sched.num_blocks):
        ids = np.where(sched.block_of_tile == j)[0]
        loads[j] = workload[ids].sum()
    mean = loads.mean() if loads.size else 0.0
    return {
        "block_loads": loads,
        "max_over_mean": float(loads.max() / mean) if mean > 0 else 1.0,
        "cv": float(loads.std() / mean) if mean > 0 else 0.0,
    }


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
    """Paper's greedy capacity fill over slots IN ORDER.

    workload: (R,) predicted pairs; active: (R,) bool. Inactive slots are
    skipped and get block -1. Returns (R,) int32 on the input's device:
    from the LDU fill kernel on CUDA tensors, its plain version on CPU
    tensors (kernels/ldu_fill.py).
    """
    return ldu_fill(workload, active, num_blocks, "greedy")


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

    if policy == "static_blocked":
        n_active = active.sum(dtype=torch.int32)
        chunk = torch.clamp_min((n_active + b - 1) // b, 1)
        blk = torch.clamp_max(pos_active // chunk, b - 1)
        block_of = torch.where(active, blk, -1).to(torch.int32)
    elif policy == "round_robin":
        block_of = torch.where(active, pos_active % b, -1).to(torch.int32)
    elif policy == "dynamic":
        # GPU-scheduler model: next active tile to the least-loaded block.
        block_of = ldu_fill(workload, active, b, "dynamic")
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
