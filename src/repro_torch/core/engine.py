"""Streaming engine (port of ``repro/core/engine.py``).

The reference folds the full/sparse loop into one ``lax.scan`` with a
``lax.cond`` per frame and ``vmap``s it over streams. Here a Python loop
over streams and frames replaces all three: the key-frame decision is
host-known, so each stream runs exactly the branch it takes (the
reference's vmapped cond runs both), and the results are the same.

Carry (``EngineCarry``): ``state`` is the reference frame a sparse frame
warps from; ``prev_pose`` the previous frame's world-to-camera (the
warp's reference camera); ``step`` the global frame index. Frame ``f`` is
fully rendered when ``f == 0 or (f + phase) % window == 0``.

Serving primitives (consumed by ``repro_torch.serve``): streams are
resumable and ragged. ``render_streams`` takes per-stream active-frame
``counts`` — frames at or past a stream's count are not rendered: they
read as zeros, get a blanked record and leave the carry frozen (its step
does not advance, so the key-frame schedule survives stalls) — plus
initial ``carries``, and returns the final carries, so a batcher threads
sessions through successive chunks with active frames identical to a
solo run. With ``slot_scene``, each stream renders its own scene from a
sequence of scenes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.camera import Camera
from repro_torch.core.pipeline import (FrameRecord, FrameState,
                                       RenderConfig, StackedRecords,
                                       TrajectoryResult, contrib_enabled,
                                       render_full_frame,
                                       render_sparse_frame, stack_fields)
from repro_torch.obs.trace import annotate


class EngineCarry(NamedTuple):
    """State threaded across frames (see module docstring). A stacked
    carry (``StreamsResult.carries``) holds fields (B, ...) and ``step``
    as a (B,) int32 tensor."""

    state: FrameState          # reference frame for the next warp
    prev_pose: torch.Tensor    # (4, 4) previous frame's world-to-camera
    step: Union[int, torch.Tensor]  # global frame index


class StreamsResult(NamedTuple):
    frames: torch.Tensor        # (B, F, H, W, 3)
    records: StackedRecords     # fields (B, F, ...)
    phases: torch.Tensor        # (B,) int32 key-frame phase offsets
    counts: torch.Tensor        # (B,) int32 active-frame counts
    frame_active: torch.Tensor  # (B, F) bool — frame within its count
    carries: EngineCarry        # final per-stream carries, fields (B, ...)


def _zero_state(cam: Camera,
                n_gaussians: Optional[int] = None) -> FrameState:
    """Placeholder state for step 0 (always full, so never read)."""
    h, w = cam.height, cam.width
    f32 = dict(dtype=torch.float32, device=cam.device)
    contrib = None if n_gaussians is None \
        else torch.full((n_gaussians,), float("inf"), **f32)
    return FrameState(
        rgb=torch.zeros((h, w, 3), **f32),
        exp_depth=torch.zeros((h, w), **f32),
        trunc_depth=torch.zeros((h, w), **f32),
        source_mask=torch.zeros((h, w), dtype=torch.bool, device=cam.device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=cam.device),
        contrib=contrib)


def init_carry(cam: Camera, pose: torch.Tensor,
               n_gaussians: Optional[int] = None) -> EngineCarry:
    """Fresh stream carry: zero state at global step 0 (first frame full).

    ``n_gaussians`` sizes the carried prior when
    ``pipeline.contrib_enabled(cfg)``.
    """
    return EngineCarry(state=_zero_state(cam, n_gaussians),
                       prev_pose=torch.as_tensor(pose, dtype=torch.float32,
                                                 device=cam.device),
                       step=0)


def stack_carries(carries: Sequence[EngineCarry]) -> EngineCarry:
    """Per-stream carries -> one carry with fields (B, ...)."""
    dev = carries[0].prev_pose.device
    return EngineCarry(
        state=stack_fields([c.state for c in carries]),
        prev_pose=torch.stack([c.prev_pose for c in carries]),
        step=torch.tensor([int(c.step) for c in carries], dtype=torch.int32,
                          device=dev))


def unstack_carries(carries: EngineCarry) -> List[EngineCarry]:
    """A stacked carry -> one carry per stream (views, host ``step``)."""
    steps = carries.step.tolist()
    return [EngineCarry(
        state=FrameState(*(None if f is None else f[i]
                           for f in carries.state)),
        prev_pose=carries.prev_pose[i], step=int(steps[i]))
        for i in range(len(steps))]


def init_stream_carries(cam: Camera, poses_batch: torch.Tensor,
                        n_gaussians: Optional[int] = None) -> EngineCarry:
    """Fresh carries for a (B, F, 4, 4) pose batch, fields (B, ...)."""
    return stack_carries([init_carry(cam, p[0], n_gaussians)
                          for p in poses_batch])


def blank_record(cam: Camera, cfg: RenderConfig,
                 n_gaussians: int) -> FrameRecord:
    """The record of a frame that is not rendered (past its stream's
    count): zero counts, no active tiles, unscheduled LDU blocks — the
    reference's ``_mask_record`` blanks, field by field."""
    t = cam.num_tiles
    dev = cam.device
    i32 = dict(dtype=torch.int32, device=dev)
    zero = torch.zeros((), **i32)
    lane_contrib = None
    if contrib_enabled(cfg):
        lane_contrib = torch.zeros((t, min(cfg.capacity, n_gaussians)),
                                   dtype=torch.float32, device=dev)
    return FrameRecord(
        is_full=torch.tensor(False, device=dev), n_gaussians=zero,
        candidate_pairs=zero, raw_pairs=torch.zeros((t,), **i32),
        sort_pairs=torch.zeros((t,), **i32),
        raster_pairs=torch.zeros((t,), **i32),
        active=torch.zeros((t,), dtype=torch.bool, device=dev),
        tiles_interpolated=zero, overflow_pairs=zero, overflow_tiles=zero,
        block_of_tile=torch.full((t,), -1, **i32),
        order_in_block=torch.zeros((t,), **i32),
        block_load=torch.zeros((cfg.ldu_blocks,), **i32),
        culled_pairs=zero, lane_contrib=lane_contrib)


def make_frame_step(scene, cam: Camera, cfg: RenderConfig, phase: int = 0,
                    stream: int = 0):
    """Build ``frame_step(carry, pose) -> (new_carry, (rgb, record))``.

    ``stream`` names the stream in the frame's span (with the carry's
    step and whether the frame is a key frame), so the host trace's
    spans of one frame share an identifier.
    """

    def frame_step(carry: EngineCarry, pose: torch.Tensor):
        tgt_cam = cam.with_pose(pose)
        is_full = carry.step == 0 or (carry.step + phase) % cfg.window == 0
        args = {"stream": stream, "step": carry.step, "key": is_full}
        if is_full:
            with annotate("repro.frame/full", args):
                out, new_state, rec = render_full_frame(
                    scene, tgt_cam, cfg, frame_idx=carry.step)
            rgb = out.rgb
        else:
            with annotate("repro.frame/sparse", args):
                rgb, new_state, rec = render_sparse_frame(
                    scene, cam.with_pose(carry.prev_pose), tgt_cam,
                    carry.state, cfg)
        new_carry = EngineCarry(state=new_state, prev_pose=pose,
                                step=carry.step + 1)
        return new_carry, (rgb, rec)

    return frame_step


def render_trajectory(scene, cam: Camera, poses: torch.Tensor,
                      cfg: RenderConfig, *, keep_states: bool = False,
                      phase: int = 0) -> TrajectoryResult:
    """Render a pose sequence with the streaming loop.

    poses: (F, 4, 4) world-to-camera per frame. ``phase`` shifts the
    key-frame schedule: frame f is full when (f + phase) % window == 0
    (frame 0 is always full).
    """
    step_fn = make_frame_step(scene, cam, cfg, int(phase))
    n = scene.means.shape[0] if contrib_enabled(cfg) else None
    carry = init_carry(cam, poses[0], n)
    frames, records, states = [], [], []
    for f in range(poses.shape[0]):
        carry, (rgb, rec) = step_fn(carry, poses[f])
        frames.append(rgb)
        records.append(rec)
        if keep_states:
            states.append(carry.state)
    return TrajectoryResult(frames=torch.stack(frames),
                            records=StackedRecords.from_list(records),
                            states=stack_fields(states) if keep_states
                            else None)


def stream_scan(scene, cam: Camera, poses: torch.Tensor, count: int,
                phase: int, cfg: RenderConfig, carry: EngineCarry,
                stream: int = 0):
    """Masked, resumable single-stream loop — the serving primitive.

    Renders frames ``0 .. count-1`` of ``poses`` (F, 4, 4) starting from
    ``carry`` (``init_carry`` for a fresh stream). Frames at or past
    ``count`` are not rendered: they read as zeros, get ``blank_record``,
    and the carry passes through untouched. Returns ``(carry_end,
    (frames (F, H, W, 3), records, frame_active (F,)))``. ``stream``
    names the stream in the frames' spans.
    """
    f = poses.shape[0]
    count = max(0, min(int(count), f))
    step_fn = make_frame_step(scene, cam, cfg, int(phase), stream)
    frames = torch.zeros((f, cam.height, cam.width, 3), dtype=torch.float32,
                         device=cam.device)
    records = []
    for i in range(count):
        carry, (rgb, rec) = step_fn(carry, poses[i])
        frames[i] = rgb
        records.append(rec)
    if count < f:
        blank = blank_record(cam, cfg, scene.means.shape[0])
        records += [blank] * (f - count)
    active = torch.arange(f, device=cam.device) < count
    return carry, (frames, StackedRecords.from_list(records), active)


def stream_phases(num_streams: int, window: int, *,
                  device="cuda") -> torch.Tensor:
    """(B,) evenly staggered key-frame phase offsets in [0, window)."""
    stride = max(1, window // max(num_streams, 1))
    return (torch.arange(num_streams, dtype=torch.int32,
                         device=resolve_device(device)) * stride) % window


def render_streams(scene, cam: Camera, poses_batch: torch.Tensor,
                   cfg: RenderConfig, *,
                   phases: Optional[Sequence[int]] = None,
                   counts: Optional[Sequence[int]] = None,
                   carries: Optional[EngineCarry] = None,
                   slot_scene: Optional[Sequence[int]] = None
                   ) -> StreamsResult:
    """Render B concurrent camera streams, one after another.

    poses_batch: (B, F, 4, 4). Each stream runs the streaming loop with
    its own carry and key-frame ``phase`` (default ``stream_phases``).
    ``counts`` (default all F) gives each stream its active-frame count;
    frames past it are not rendered (zero frames, blanked records,
    frozen carry). ``carries`` (default fresh ``init_carry`` per stream)
    resumes each stream; the final carries come back stacked.

    ``slot_scene`` (default None: one shared scene) makes ``scene`` a
    sequence of scenes and gives each stream slot its index into it; an
    active stream renders exactly as ``render_trajectory`` over its own
    scene would.
    """
    b, f = poses_batch.shape[0], poses_batch.shape[1]
    dev = cam.device
    scenes = None if slot_scene is None else list(scene)
    first = scene if scenes is None else scenes[0]
    n = first.means.shape[0] if contrib_enabled(cfg) else None
    phases = stream_phases(b, cfg.window, device=dev) if phases is None \
        else torch.as_tensor(phases, dtype=torch.int32).to(dev)
    counts = torch.full((b,), f, dtype=torch.int32, device=dev) \
        if counts is None \
        else torch.as_tensor(counts, dtype=torch.int32).to(dev)
    if carries is None:
        carries = init_stream_carries(cam, poses_batch, n)
    starts = unstack_carries(carries)
    slot_ids = [0] * b if slot_scene is None \
        else torch.as_tensor(slot_scene).tolist()
    ends, frames, records, active = [], [], [], []
    for i, (count, phase) in enumerate(zip(counts.tolist(),
                                           phases.tolist())):
        sc = scene if scenes is None else scenes[slot_ids[i]]
        with annotate(f"repro.stream/{i}"):
            end, (fr, rec, act) = stream_scan(sc, cam, poses_batch[i], count,
                                              phase, cfg, starts[i], i)
        ends.append(end)
        frames.append(fr)
        records.append(rec.stacked)
        active.append(act)
    return StreamsResult(frames=torch.stack(frames),
                         records=StackedRecords(stack_fields(records)),
                         phases=phases, counts=counts,
                         frame_active=torch.stack(active),
                         carries=stack_carries(ends))
