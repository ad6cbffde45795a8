"""Streaming engine, single stream (port of ``repro/core/engine.py``;
``render_streams`` and the serving primitives are not ported yet).

The reference folds the full/sparse loop into one ``lax.scan`` with a
``lax.cond`` per frame. Here a Python frame loop replaces both: the key
frame decision is host-known, so each frame runs exactly one branch.

Carry (``EngineCarry``): ``state`` is the reference frame a sparse frame
warps from; ``prev_pose`` the previous frame's world-to-camera (the
warp's reference camera); ``step`` the global frame index. Frame ``f`` is
fully rendered when ``f == 0 or (f + phase) % window == 0``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.pipeline import (FrameState, RenderConfig,
                                       StackedRecords, TrajectoryResult,
                                       contrib_enabled, render_full_frame,
                                       render_sparse_frame, stack_fields)
from repro_torch.obs.trace import annotate


class EngineCarry(NamedTuple):
    """State threaded across frames (see module docstring)."""

    state: FrameState          # reference frame for the next warp
    prev_pose: torch.Tensor    # (4, 4) previous frame's world-to-camera
    step: int                  # global frame index


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


def make_frame_step(scene, cam: Camera, cfg: RenderConfig, phase: int = 0):
    """Build ``frame_step(carry, pose) -> (new_carry, (rgb, record))``."""

    def frame_step(carry: EngineCarry, pose: torch.Tensor):
        tgt_cam = cam.with_pose(pose)
        is_full = carry.step == 0 or (carry.step + phase) % cfg.window == 0
        if is_full:
            with annotate("repro.frame/full"):
                out, new_state, rec = render_full_frame(
                    scene, tgt_cam, cfg, frame_idx=carry.step)
            rgb = out.rgb
        else:
            with annotate("repro.frame/sparse"):
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
