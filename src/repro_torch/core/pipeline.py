"""LS-Gaussian end-to-end renderer: plan-driven full + TWSR sparse frames
(port of ``repro/core/pipeline.py``).

Every frame renders through ONE shared stage pipeline,
``render_planned_frame``: preprocess -> plan-masked intersect -> (R, K)
compacted binning with DPES limits -> LDU schedule -> raster over the
plan's R slots -> scatter back to the full frame. Key frames carry an
all-tiles ``TilePlan`` (R = T); TWSR frames carry the warp-predicted
re-render set compacted to ``R = rerender_capacity``.

``render_trajectory`` (core/engine.py) is the entry point; the host loop
``render_trajectory_py`` below is kept for golden comparison.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import binning, culling, intersect
from repro_torch.core import plan as plan_mod
from repro_torch.core import warp as warp_mod
from repro_torch.core.camera import TILE, Camera
from repro_torch.core.plan import TilePlan
from repro_torch.core.projection import preprocess
from repro_torch.core.raster import RenderOutput, render_plan_slots, untile
from repro_torch.kernels import intersect_bin
from repro_torch.obs.trace import annotate

# Gaussian x slot pairs per intersect/bin block of the dense path (the
# methods other than TAIT): the (N, R) masks and the (R, N) selection keys
# are built a block of active slots at a time, which bounds the peak
# memory without changing any mask, bin or count.
PAIR_BLOCK = 1 << 26


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    intersect_method: str = "tait"      # "aabb" | "obb" | "tait" | "exact"
    capacity: int = 512                 # K: max pairs per tile
    chunk: int = 64                     # rasterizer gaussian-chunk
    # Raster kernel (kernels/ops.py): "cuda_fused" | "cuda" |
    # "torch_chunked" | "ref"; None picks ops.default_impl for the
    # scene's device.
    impl: Optional[str] = None
    window: int = 5                     # full render every n-th frame
    use_mask: bool = True               # no-cumulative-error mask (Fig. 7)
    use_dpes: bool = True
    dpes_margin: float = 1.0
    n0_ratio: float = warp_mod.N0_RATIO
    inpaint_iters: int = 8
    near: float = 0.05
    min_coverage: float = warp_mod.MIN_COVERAGE
    rerender_capacity: Optional[int] = None  # R: static cap on plan slots
    ldu_blocks: int = 32                # B: parallel raster blocks (LDU)
    # Temporal contribution culling (core/culling.py): on sparse frames,
    # drop pairs whose Gaussian contributed < cull_threshold blend mass at
    # the last key frame, before binning. 0.0 leaves the pass out.
    cull_threshold: float = 0.0
    # Populate FrameRecord.lane_contrib / FrameState.contrib.
    record_contrib: bool = False


def contrib_enabled(cfg: RenderConfig) -> bool:
    """Is the contribution/prior machinery threaded? When False,
    ``FrameState.contrib``, ``PlanStats.gauss_prior`` and
    ``FrameRecord.lane_contrib`` stay None."""
    return cfg.cull_threshold > 0.0 or cfg.record_contrib


class FrameState(NamedTuple):
    """Reference-frame state carried across the streaming loop."""

    rgb: torch.Tensor          # (H, W, 3)
    exp_depth: torch.Tensor    # (H, W)
    trunc_depth: torch.Tensor  # (H, W)
    source_mask: torch.Tensor  # (H, W) bool — usable reprojection sources
    frame_idx: torch.Tensor    # () int32 — true global frame index
    contrib: Optional[torch.Tensor] = None  # (N,) float32 key-frame prior


class FrameRecord(NamedTuple):
    """Per-frame workload summary."""

    is_full: torch.Tensor          # () bool
    n_gaussians: torch.Tensor      # () int32 — valid after frustum cull
    candidate_pairs: torch.Tensor  # () int32 — pairs entering stage-2 test
    raw_pairs: torch.Tensor        # (T,) int32 pre-DPES pairs
    sort_pairs: torch.Tensor       # (T,) int32 post-DPES pairs entering sort
    raster_pairs: torch.Tensor     # (T,) int32 pairs actually traversed
    active: torch.Tensor           # (T,) bool — re-rendered tiles
    tiles_interpolated: torch.Tensor  # () int32
    overflow_pairs: torch.Tensor   # () int32 — bin-capacity overflow
    overflow_tiles: torch.Tensor   # () int32 — rerender_capacity overflow
    block_of_tile: torch.Tensor    # (T,) int32 — LDU block (-1 = none)
    order_in_block: torch.Tensor   # (T,) int32 — light-to-heavy position
    block_load: torch.Tensor       # (B,) int32 — predicted pairs per block
    culled_pairs: torch.Tensor     # () int32 — pairs removed by culling
    lane_contrib: Optional[torch.Tensor] = None  # (T, K) float32


class PlanStats(NamedTuple):
    """Per-slot counters from the shared stage pipeline (R-shaped)."""

    candidate_pairs: torch.Tensor  # () int32
    raw_slots: torch.Tensor        # (R,) int32 pre-DPES pairs per slot
    overflow_pairs: torch.Tensor   # () int32
    culled_pairs: torch.Tensor     # () int32
    gauss_prior: Optional[torch.Tensor] = None  # (N,) float32


def _tile_flag_to_pixels(flag: torch.Tensor, tiles_x: int, tiles_y: int):
    """(T,) -> (H, W) by broadcasting each flag over its tile."""
    tiles = flag[:, None, None].expand(flag.shape[0], TILE, TILE)
    return untile(tiles, tiles_x, tiles_y)


def intersect_and_bin(proj, grid, plan: TilePlan, cfg: RenderConfig,
                      limit: Optional[torch.Tensor],
                      cull: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Plan-masked intersect, contribution cull and (R, K) binning over
    the plan's active slots on ``grid``.

    ``cull`` is ``(prior, gate)`` (core/culling.py) or None for no cull.
    Inactive slots read as the reference computes them: no pairs, empty
    bins (indices 0..K-1, as top-k of an all-masked row gives). Returns
    (bins, candidate_pairs, raw_slots, culled_pairs, slot_active), the
    last with fully-culled slots demoted.

    TAIT goes through ``kernels/intersect_bin.py``: each Gaussian's pairs
    with the tiles of its box, then each slot's K nearest (the CUDA kernel
    on CUDA tensors). The other methods (the paper's baselines) test every
    Gaussian against every active slot, a block of slots at a time. Both
    wait for the device once a call.
    """
    if cfg.intersect_method != "tait":
        return dense_intersect_and_bin(proj, grid, plan, cfg, limit, cull)
    with annotate("repro.frame/intersect"):
        keep = None if cull is None else (cull[0] >= cfg.cull_threshold,
                                          cull[1])
        pairs = intersect_bin.intersect_pairs(
            proj, grid, plan.tile_ids, plan.slot_active, limit, keep)
    with annotate("repro.frame/bin"):
        bins = intersect_bin.select_bins(pairs, cfg.capacity)
    return (bins, pairs.candidate_pairs, pairs.raw_slots, pairs.culled_pairs,
            pairs.slot_active)


def dense_intersect_and_bin(proj, grid, plan: TilePlan, cfg: RenderConfig,
                            limit: Optional[torch.Tensor],
                            cull: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None):
    """``intersect_and_bin`` by (N, R) masks and top-k, a block of active
    slots at a time: the path of the methods other than TAIT, and for
    TAIT the oracle the sparse path is held to."""
    n = proj.depth.shape[0]
    r, k = plan.num_slots, min(cfg.capacity, n)
    dev = proj.depth.device
    i32 = dict(dtype=torch.int32, device=dev)
    bins = binning.TileBins(
        indices=torch.arange(k, **i32).repeat(r, 1),
        valid=torch.zeros((r, k), dtype=torch.bool, device=dev),
        count=torch.zeros((r,), **i32), overflow=torch.zeros((r,), **i32),
        capacity=cfg.capacity)
    raw_slots = torch.zeros((r,), **i32)
    candidate_pairs = torch.zeros((), **i32)
    culled_pairs = torch.zeros((), **i32)
    slot_active = plan.slot_active.clone()
    active = torch.nonzero(plan.slot_active).squeeze(1)
    slots = intersect.take_tiles(grid, plan.tile_ids)
    rows = max(1, PAIR_BLOCK // max(n, 1))
    for r0 in range(0, active.shape[0], rows):
        ids = active[r0:r0 + rows]
        block = intersect.TileSlots(slots.centers[ids], slots.origins[ids])
        with annotate("repro.frame/intersect"):
            if cfg.intersect_method == "tait":
                cand_src = intersect.tait_stage1_mask(proj, block)
                mask = cand_src & intersect.tait_stage2_keep(proj, block)
            else:
                mask = intersect.intersect(proj, block, cfg.intersect_method)
                cand_src = mask
            candidate_pairs += cand_src.sum(dtype=torch.int32)
        if cull is not None:
            with annotate("repro.frame/cull"):
                mask, slot_active[ids], culled = culling.cull_pairs(
                    mask, slot_active[ids], plan.tile_ids[ids], cull[0],
                    cull[1], cfg.cull_threshold)
                culled_pairs += culled
        raw_slots[ids] = mask.sum(dim=0, dtype=torch.int32)
        with annotate("repro.frame/bin"):
            part = binning.build_tile_bins(
                mask, proj.depth, cfg.capacity,
                depth_limit=None if limit is None else limit[ids])
            for field in ("indices", "valid", "count", "overflow"):
                getattr(bins, field)[ids] = getattr(part, field)
    return bins, candidate_pairs, raw_slots, culled_pairs, slot_active


def render_planned_frame(scene, cam: Camera, plan: TilePlan,
                         cfg: RenderConfig, *,
                         dpes_depth: Optional[torch.Tensor] = None,
                         cull_prior: Optional[torch.Tensor] = None,
                         cull_gate: Optional[torch.Tensor] = None
                         ) -> Tuple[RenderOutput, TilePlan, torch.Tensor,
                                    PlanStats]:
    """The ONE shared stage pipeline every frame renders through.

    dpes_depth: optional (T,) per-tile early-stop depth (inf = no prior);
    gathered to the plan's slots before binning.

    cull_prior: optional (N,) key-frame contribution prior; with
    ``cfg.cull_threshold > 0`` low-contribution pairs are removed before
    binning in slots passed by ``cull_gate`` ((T,) bool, default all
    True), and fully-culled slots are demoted (core/culling.py). With the
    default threshold 0.0 the pass is left out.

    Returns ``(out, plan, n_gaussians, stats)``: the full-frame
    RenderOutput (unplanned tiles empty), the plan with its LDU schedule
    and per-slot workloads, the valid-Gaussian count, and the per-slot
    counters the wrappers fold into a ``FrameRecord``.
    """
    with annotate("repro.frame/preprocess"):
        proj = preprocess(scene, cam, near=cfg.near)
        grid = intersect.make_tile_grid(cam)
        slots = intersect.take_tiles(grid, plan.tile_ids)
    limit = None
    if dpes_depth is not None:
        limit = dpes_depth[plan.tile_ids.long()] * cfg.dpes_margin
    cull = None
    if cfg.cull_threshold > 0.0 and cull_prior is not None:
        gate = cull_gate if cull_gate is not None else torch.ones(
            (cam.num_tiles,), dtype=torch.bool, device=cam.device)
        cull = (cull_prior, gate)
    bins, candidate_pairs, raw_slots, culled_pairs, slot_active = \
        intersect_and_bin(proj, grid, plan, cfg, limit, cull)
    plan = plan._replace(slot_active=slot_active)
    # LDU (paper Sec. V-B): post-DPES counts are the workload prediction.
    with annotate("repro.frame/ldu_schedule"):
        plan = plan_mod.schedule_plan(plan, bins.count, cfg.ldu_blocks)
    with annotate("repro.frame/raster"):
        out = render_plan_slots(proj, bins, slots.origins, plan.tile_ids,
                                grid, impl=cfg.impl, chunk=cfg.chunk,
                                slot_active=plan.slot_active,
                                contrib=contrib_enabled(cfg))
    gauss_prior = None
    if contrib_enabled(cfg):
        # "Considered" = occupies a valid bin lane anywhere on the plan;
        # everyone else gets inf (= always keep).
        considered = torch.zeros_like(proj.valid)
        considered[bins.indices[bins.valid].long()] = True
        gauss_prior = torch.where(considered, out.gauss_contrib,
                                  float("inf"))
    stats = PlanStats(candidate_pairs=candidate_pairs, raw_slots=raw_slots,
                      overflow_pairs=bins.overflow.sum(dtype=torch.int32),
                      culled_pairs=culled_pairs, gauss_prior=gauss_prior)
    n_gaussians = proj.valid.sum(dtype=torch.int32)
    return out, plan, n_gaussians, stats


def _plan_record(plan: TilePlan, stats: PlanStats, out: RenderOutput,
                 n_gaussians: torch.Tensor, num_tiles: int,
                 cfg: RenderConfig, *, is_full: bool,
                 tiles_interpolated: torch.Tensor) -> FrameRecord:
    """Fold plan-slot counters into the (T,)-shaped FrameRecord."""
    scat = functools.partial(plan_mod.scatter_slots, plan,
                             num_tiles=num_tiles)
    return FrameRecord(
        is_full=torch.tensor(is_full, device=n_gaussians.device),
        n_gaussians=n_gaussians,
        candidate_pairs=stats.candidate_pairs,
        raw_pairs=scat(stats.raw_slots),
        sort_pairs=scat(plan.workload),
        raster_pairs=out.processed_pairs,
        active=scat(plan.slot_active, fill=False),
        tiles_interpolated=tiles_interpolated,
        overflow_pairs=stats.overflow_pairs,
        overflow_tiles=plan.overflow_tiles,
        block_of_tile=scat(plan.block_of, fill=-1),
        order_in_block=scat(plan.order_in_block),
        block_load=plan_mod.block_loads(plan, cfg.ldu_blocks),
        culled_pairs=stats.culled_pairs,
        lane_contrib=scat(out.lane_contrib) if contrib_enabled(cfg)
        else None)


def render_full_frame(scene, cam: Camera, cfg: RenderConfig,
                      frame_idx: Union[int, torch.Tensor] = 0
                      ) -> Tuple[RenderOutput, FrameState, FrameRecord]:
    """Key frame: ``render_planned_frame`` with an all-tiles plan (R = T).

    ``frame_idx`` is the frame's true global index.
    """
    tplan = plan_mod.full_plan(cam.tiles_x, cam.tiles_y, device=cam.device)
    out, tplan, n_gaussians, stats = render_planned_frame(scene, cam, tplan,
                                                          cfg)
    coverage = 1.0 - out.transmittance
    state = FrameState(
        rgb=out.rgb, exp_depth=out.exp_depth, trunc_depth=out.trunc_depth,
        source_mask=coverage > cfg.min_coverage,
        frame_idx=torch.as_tensor(frame_idx, dtype=torch.int32,
                                  device=cam.device),
        contrib=stats.gauss_prior)
    zero = torch.zeros((), dtype=torch.int32, device=cam.device)
    rec = _plan_record(tplan, stats, out, n_gaussians, cam.num_tiles, cfg,
                       is_full=True, tiles_interpolated=zero)
    return out, state, rec


def render_sparse_frame(scene, ref_cam: Camera, tgt_cam: Camera,
                        state: FrameState, cfg: RenderConfig
                        ) -> Tuple[torch.Tensor, FrameState, FrameRecord]:
    """TWSR frame (Algo. 1): warp, plan the re-render set, render the plan.

    Re-render tiles beyond ``rerender_capacity`` degrade to interpolation
    and are counted.
    """
    with annotate("repro.frame/warp"):
        w = warp_mod.viewpoint_transform(
            state.rgb, state.exp_depth, state.trunc_depth,
            state.source_mask, ref_cam, tgt_cam, n0_ratio=cfg.n0_ratio,
            near=cfg.near)
        tplan = plan_mod.sparse_plan(w.rerender_tile, tgt_cam.tiles_x,
                                     tgt_cam.tiles_y, cfg.rerender_capacity)

    limit = w.dpes_depth if cfg.use_dpes else None
    gate = culling.warp_gate(w.valid_per_tile) \
        if cfg.cull_threshold > 0.0 else None
    out, tplan, n_gaussians, stats = render_planned_frame(
        scene, tgt_cam, tplan, cfg, dpes_depth=limit,
        cull_prior=state.contrib, cull_gate=gate)
    # Effective re-render set: plan slots that survived compaction.
    rerender = plan_mod.scatter_slots(tplan, tplan.slot_active,
                                      num_tiles=tgt_cam.num_tiles,
                                      fill=False)

    # Compose: interpolated tiles take the warped pixels with diffusion-
    # inpainted holes; the depth maps ride the same inpainting.
    with annotate("repro.frame/compose"):
        stacked = torch.cat([w.rgb, w.exp_depth[..., None],
                             w.trunc_depth[..., None]], dim=-1)
        inpainted = warp_mod.inpaint(stacked, w.filled,
                                     iters=cfg.inpaint_iters)
        rr_px = _tile_flag_to_pixels(rerender, tgt_cam.tiles_x,
                                     tgt_cam.tiles_y)
        rgb_final = torch.where(rr_px[..., None], out.rgb,
                                inpainted[..., :3])
        exp_depth = torch.where(rr_px, out.exp_depth, inpainted[..., 3])
        trunc_depth = torch.where(rr_px, out.trunc_depth, inpainted[..., 4])

    # Next-frame source mask (the "TW w/ mask" mechanism).
    coverage_ok = (1.0 - out.transmittance) > cfg.min_coverage
    if cfg.use_mask:
        src = torch.where(rr_px, coverage_ok, w.filled)
    else:
        interpolated_px = (~rr_px) & (~w.filled)
        src = torch.where(rr_px, coverage_ok, w.filled | interpolated_px)
    # Priors refresh only at key frames; sparse frames carry them through.
    new_state = FrameState(rgb=rgb_final, exp_depth=exp_depth,
                           trunc_depth=trunc_depth, source_mask=src,
                           frame_idx=state.frame_idx + 1,
                           contrib=state.contrib)
    rec = _plan_record(
        tplan, stats, out, n_gaussians, tgt_cam.num_tiles, cfg,
        is_full=False,
        tiles_interpolated=w.interpolate_tile.sum(dtype=torch.int32))
    return rgb_final, new_state, rec


def stack_fields(items):
    """Stack a list of NamedTuples field by field (None fields stay None)."""
    first = items[0]
    return type(first)(*(
        None if getattr(first, f) is None
        else torch.stack([getattr(x, f) for x in items])
        for f in first._fields))


class StackedRecords:
    """Per-frame records stacked along a leading frame axis ``(F, ...)``.

    Attribute access returns the stacked tensor (``records.raster_pairs``
    -> ``(F, T)``); indexing recovers a per-frame ``FrameRecord``.
    """

    __slots__ = ("stacked",)

    def __init__(self, stacked: FrameRecord):
        self.stacked = stacked

    @classmethod
    def from_list(cls, records: Sequence[FrameRecord]) -> "StackedRecords":
        return cls(stack_fields(list(records)))

    def __len__(self) -> int:
        return int(self.stacked.is_full.shape[0])

    def __getitem__(self, i) -> FrameRecord:
        return FrameRecord(*(None if a is None else a[i]
                             for a in self.stacked))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getattr__(self, name):
        return getattr(self.stacked, name)


class TrajectoryResult(NamedTuple):
    frames: torch.Tensor             # (F, H, W, 3)
    records: StackedRecords
    states: Optional[FrameState]     # stacked (F, ...) when keep_states


def render_trajectory(scene, cam: Camera, poses: torch.Tensor,
                      cfg: RenderConfig, *, keep_states: bool = False,
                      phase: int = 0) -> TrajectoryResult:
    """Render a pose sequence with the LS-Gaussian streaming loop (see
    ``core/engine.py``). Frame f is fully rendered when
    (f + phase) % cfg.window == 0 or f == 0, warped otherwise."""
    from repro_torch.core import engine  # engine builds on this module
    return engine.render_trajectory(scene, cam, poses, cfg,
                                    keep_states=keep_states, phase=phase)


def render_trajectory_py(scene, cam: Camera, poses: torch.Tensor,
                         cfg: RenderConfig, *, keep_states: bool = False
                         ) -> TrajectoryResult:
    """Golden host loop: frame f is fully rendered when
    f % cfg.window == 0, warped otherwise."""
    frames, records, states = [], [], []
    state = None
    ref_cam = None
    for f in range(poses.shape[0]):
        cam_f = cam.with_pose(poses[f])
        if f % cfg.window == 0 or state is None:
            out, state, rec = render_full_frame(scene, cam_f, cfg,
                                                frame_idx=f)
            frames.append(out.rgb)
        else:
            rgb, state, rec = render_sparse_frame(scene, ref_cam, cam_f,
                                                  state, cfg)
            frames.append(rgb)
        ref_cam = cam_f
        records.append(rec)
        if keep_states:
            states.append(state)
    return TrajectoryResult(frames=torch.stack(frames),
                            records=StackedRecords.from_list(records),
                            states=stack_fields(states) if keep_states
                            else None)
