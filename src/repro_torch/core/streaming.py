"""Streaming-accelerator timing model (the port's own copy of
``repro/core/streaming.py``, paper Sec. V): a discrete-event model of the
CCU (preprocess), VTU (warp), the shared GSU sorter and ``num_blocks``
parallel VRU raster blocks. Streaming mode lets each unit free-run into
the next frame; non-streaming inserts a frame barrier.

Host-side numpy, fed from the renderer's ``FrameRecord``s.
``policy="recorded"`` (the default here) replays the LDU schedule the
renderer recorded, which is what the serve loop's ``sim_latency`` report
uses; the other policies re-derive the schedule on the host through the
numpy golden ``load_balance.schedule`` and reproduce the paper's
ablation (Figs. 14/15, Tab. I).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.load_balance import Schedule, morton_order, schedule
from repro_torch.interop import to_numpy


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Unit service rates, calibrated so the relative stage costs match the
    paper's setting: rasterization dominates, per-tile sorting is ~8x
    faster than per-tile rasterization, and the aggregate sorter
    throughput exceeds aggregate VRU consumption (Sec. V-B: "the sorting
    process typically takes less time than rasterization")."""

    num_blocks: int = 32
    ccu_rate: float = 2.0        # gaussians / cycle
    intersect_rate: float = 32.0  # candidate pairs / cycle (stage-2 test)
    gsu_rate: float = 64.0       # pairs / cycle through the (shared) sorter
    vru_rate: float = 1.0        # pairs / cycle / block (256 px lanes)
    vtu_rate: float = 8.0        # pixels / cycle (3 mat-vec muls, pipelined)
    tile_overhead: float = 16.0  # fixed cycles per tile (setup/drain)


@dataclasses.dataclass(frozen=True)
class FrameWork:
    """Workload summary of one frame (from the real pipeline's stats)."""

    n_gaussians: int              # CCU transform work
    candidate_pairs: int          # stage-1 pairs entering the stage-2 test
    raw_pairs: np.ndarray         # (T,) pairs per tile before DPES culling
    sort_pairs: np.ndarray        # (T,) pairs entering sort, post-DPES
    raster_pairs: np.ndarray      # (T,) pairs actually blended (early stop)
    active: np.ndarray            # (T,) bool — tiles that re-render
    n_warp_pixels: int = 0        # VTU work (0 for full frames)
    tiles_x: int = 0
    tiles_y: int = 0
    # Device-LDU schedule recorded by the plan-driven renderer
    # (FrameRecord.block_of_tile / order_in_block); lets the simulator
    # serve exactly what the jitted engine scheduled (policy="recorded")
    # instead of re-deriving it host-side.
    block_of: Optional[np.ndarray] = None       # (T,) int, -1 = unscheduled
    order_in_block: Optional[np.ndarray] = None  # (T,) int
    num_blocks: int = 0           # B the device schedule was built for


def frameworks_from_stacked(records, tiles_x: int, tiles_y: int,
                            n_pixels: int) -> List[FrameWork]:
    """Stacked per-frame record arrays -> per-frame ``FrameWork`` list.

    ``records`` is anything exposing the scanned engine's stacked
    ``FrameRecord`` fields with a leading frame axis ``(F, ...)``
    (``pipeline.StackedRecords`` or the raw stacked NamedTuple). The
    whole trajectory crosses the host boundary in one transfer per
    field, instead of one per frame as with ``List[FrameRecord]``.
    """
    is_full = to_numpy(records.is_full)
    if is_full.ndim != 1:
        raise ValueError(
            f"expected single-trajectory records with (F, ...) fields, got "
            f"is_full shape {is_full.shape}; for multi-stream (B, F, ...) "
            f"records pass one stream at a time, e.g. "
            f"frameworks_from_stacked(StackedRecords(records[i]), ...)")
    n_gaussians = to_numpy(records.n_gaussians)
    candidate = to_numpy(records.candidate_pairs)
    raw = to_numpy(records.raw_pairs)
    sort = to_numpy(records.sort_pairs)
    raster = to_numpy(records.raster_pairs)
    active = to_numpy(records.active)
    block_of = to_numpy(records.block_of_tile)
    order_in = to_numpy(records.order_in_block)
    num_blocks = int(to_numpy(records.block_load).shape[-1])
    return [FrameWork(
        n_gaussians=int(n_gaussians[f]),
        candidate_pairs=int(candidate[f]),
        raw_pairs=raw[f], sort_pairs=sort[f], raster_pairs=raster[f],
        active=active[f],
        n_warp_pixels=0 if is_full[f] else n_pixels,
        tiles_x=tiles_x, tiles_y=tiles_y,
        block_of=block_of[f], order_in_block=order_in[f],
        num_blocks=num_blocks)
        for f in range(is_full.shape[0])]


@dataclasses.dataclass
class FrameTiming:
    prep_end: float
    frame_end: float
    vru_busy: float
    vru_span: float
    utilization: float
    sort_stall: float            # cycles blocks spent waiting on GSU
    idle_stall: float            # inter-block tail idling


def _simulate_raster(work: FrameWork, sched: Schedule,
                     cfg: AcceleratorConfig, prep_end: float,
                     gsu_free: float, vru_free: np.ndarray):
    """Event-driven GSU + VRU simulation for one frame."""
    b = sched.num_blocks
    # Global sort service order: tiles needed earliest first.
    entries = []
    for j in range(b):
        for pos, tid in enumerate(sched.tiles_of_block(j)):
            entries.append((pos, j, tid))
    entries.sort()

    sort_end = {}
    t_gsu = max(gsu_free, prep_end)
    for pos, j, tid in entries:
        t_gsu += float(work.sort_pairs[tid]) / cfg.gsu_rate
        sort_end[tid] = t_gsu

    block_free = vru_free.copy()
    busy = np.zeros(b)
    sort_stall = 0.0
    start_min = np.inf
    for pos, j, tid in entries:
        ready = max(sort_end[tid], prep_end)
        start = max(block_free[j], ready)
        # Intra-block bubble: waiting on the sorter beyond both the block's
        # own availability and frame prep (the paper's "rasterization
        # bubbles", Sec. III Obs. 2).
        sort_stall += max(sort_end[tid] - max(block_free[j], prep_end), 0.0)
        dur = float(work.raster_pairs[tid]) / cfg.vru_rate + cfg.tile_overhead
        block_free[j] = start + dur
        busy[j] += dur
        start_min = min(start_min, start)

    frame_end = float(block_free.max()) if entries else prep_end
    span = frame_end - (start_min if np.isfinite(start_min) else prep_end)
    util = float(busy.sum() / (b * span)) if span > 0 else 1.0
    idle = float((frame_end - block_free).sum()) if entries else 0.0
    return frame_end, t_gsu, block_free, FrameTiming(
        prep_end=prep_end, frame_end=frame_end, vru_busy=float(busy.sum()),
        vru_span=span, utilization=util, sort_stall=sort_stall,
        idle_stall=idle)


def simulate_sequence(frames: Sequence[FrameWork], cfg: AcceleratorConfig,
                      *, policy: str = "ls_gaussian",
                      workload_source: str = "dpes",
                      light_to_heavy: bool = True,
                      streaming: bool = True) -> List[FrameTiming]:
    """Simulate a frame sequence; returns per-frame timings.

    policy/workload_source/light_to_heavy reproduce the paper's ablation:
      - GSCore-like baseline : policy="round_robin", workload_source="raw",
                               light_to_heavy=False
      - + LD1 (inter-block)  : policy="ls_gaussian", light_to_heavy=False
      - + LD2 (intra-block)  : light_to_heavy=True (full LS-Gaussian)
      - recorded             : policy="recorded" — serve the LDU
                               schedule the plan-driven renderer
                               recorded in the FrameRecord (no host
                               re-derivation; requires matching
                               cfg.num_blocks)
    """
    timings: List[FrameTiming] = []
    ccu_free = 0.0
    vtu_free = 0.0
    gsu_free = 0.0
    vru_free = np.zeros(cfg.num_blocks)
    frame_barrier = 0.0

    for work in frames:
        ccu_start = max(ccu_free, frame_barrier)
        ccu_end = ccu_start + work.n_gaussians / cfg.ccu_rate \
            + work.candidate_pairs / cfg.intersect_rate
        vtu_start = max(vtu_free, frame_barrier)
        vtu_end = vtu_start + work.n_warp_pixels / cfg.vtu_rate
        prep_end = max(ccu_end, vtu_end)
        ccu_free, vtu_free = ccu_end, vtu_end

        if policy == "recorded":
            if work.block_of is None or work.order_in_block is None:
                raise ValueError(
                    "policy='recorded' needs FrameWork.block_of / "
                    "order_in_block from the plan-driven renderer")
            if work.num_blocks and work.num_blocks != cfg.num_blocks:
                raise ValueError(
                    f"recorded schedule was built for {work.num_blocks} "
                    f"blocks but the simulator has {cfg.num_blocks}")
            if np.max(work.block_of, initial=-1) >= cfg.num_blocks:
                raise ValueError(
                    f"recorded schedule assigns block "
                    f"{int(np.max(work.block_of))} but the simulator only "
                    f"has {cfg.num_blocks} blocks")
            sched = Schedule(
                block_of_tile=np.asarray(work.block_of, np.int64),
                order_in_block=np.asarray(work.order_in_block, np.int64),
                num_blocks=cfg.num_blocks)
        else:
            # Without DPES the LDU only knows raw (pre-cull) pair counts;
            # with it, post-cull counts are an accurate raster predictor.
            wl = work.sort_pairs if workload_source == "dpes" \
                else work.raw_pairs
            sched = schedule(np.asarray(wl), cfg.num_blocks, policy=policy,
                             tiles_x=work.tiles_x, tiles_y=work.tiles_y,
                             active=np.asarray(work.active))
            if policy == "ls_gaussian" and not light_to_heavy:
                # strip the intra-block reordering: arrival (Morton) order
                sched = dataclasses.replace(
                    sched, order_in_block=_arrival_order(sched, work))

        frame_end, gsu_free, vru_free, t = _simulate_raster(
            work, sched, cfg, prep_end, gsu_free, vru_free)
        timings.append(t)
        frame_barrier = frame_end if not streaming else 0.0
        if not streaming:
            # global sync: every unit drains
            ccu_free = vtu_free = gsu_free = frame_end
            vru_free = np.full(cfg.num_blocks, frame_end)
    return timings


def _arrival_order(sched: Schedule, work: FrameWork) -> np.ndarray:
    order = np.zeros_like(sched.order_in_block)
    visit = morton_order(work.tiles_x, work.tiles_y)
    for j in range(sched.num_blocks):
        ids = [tid for tid in visit if sched.block_of_tile[tid] == j]
        for pos, tid in enumerate(ids):
            order[tid] = pos
    return order


def throughput(timings: Sequence[FrameTiming],
               num_blocks: Optional[int] = None) -> dict:
    """Steady-state cycles/frame + utilization + stall breakdown.

    Utilization (Tab. I metric) is computed globally: total VRU busy
    cycles over (blocks x wall span of the raster phase), so overlapping
    streaming frames are accounted once.
    """
    if len(timings) < 2:
        span = timings[0].frame_end if timings else 0.0
        n = max(len(timings), 1)
    else:
        span = timings[-1].frame_end - timings[0].frame_end
        n = len(timings) - 1
    busy = float(np.sum([t.vru_busy for t in timings]))
    spans = float(np.sum([t.vru_span for t in timings]))
    b = num_blocks if num_blocks is not None else _infer_blocks(timings)
    return {
        "cycles_per_frame": span / n,
        # Tab. I metric: raster-core busy over (blocks x raster-phase
        # span) — load imbalance + sort bubbles, not other units' time.
        "utilization": busy / (b * spans) if spans > 0 else 1.0,
        "sort_stall": float(np.mean([t.sort_stall for t in timings])),
        "idle_stall": float(np.mean([t.idle_stall for t in timings])),
    }


def _infer_blocks(timings: Sequence[FrameTiming]) -> int:
    # busy <= B * span per frame; tightest bound across frames.
    est = max(int(np.ceil(t.vru_busy / t.vru_span)) if t.vru_span > 0 else 1
              for t in timings)
    return max(est, 1)
