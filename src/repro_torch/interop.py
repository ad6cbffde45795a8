"""Carry weights and state into and out of the port as numpy arrays.

The reference's scenes, cameras and frame states reach the port as
numpy arrays (``np.asarray`` on each field), so the port never sees an
object of another framework; ``to_numpy`` converts the port's results
back for comparison.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.pipeline import FrameState


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def scene_from_numpy(means, log_scales, quats, opacity_logits, sh, *,
                     device="cuda") -> GaussianScene:
    """GaussianScene of float32 tensors on ``device``."""
    dev = resolve_device(device)
    return GaussianScene(*(_tensor(x, torch.float32, dev) for x in
                           (means, log_scales, quats, opacity_logits, sh)))


def camera_from_numpy(w2c, fx: float, fy: float, cx: float, cy: float,
                      width: int, height: int, *, device="cuda") -> Camera:
    """Camera with a (4, 4) float32 pose on ``device``."""
    return Camera(w2c=_tensor(w2c, torch.float32, resolve_device(device)),
                  fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                  width=int(width), height=int(height))


def frame_state_from_numpy(rgb, exp_depth, trunc_depth, source_mask,
                           frame_idx, contrib: Optional[Any] = None, *,
                           device="cuda") -> FrameState:
    """FrameState on ``device`` (bool mask, int32 frame index)."""
    dev = resolve_device(device)
    return FrameState(
        rgb=_tensor(rgb, torch.float32, dev),
        exp_depth=_tensor(exp_depth, torch.float32, dev),
        trunc_depth=_tensor(trunc_depth, torch.float32, dev),
        source_mask=_tensor(source_mask, torch.bool, dev),
        frame_idx=_tensor(frame_idx, torch.int32, dev),
        contrib=None if contrib is None
        else _tensor(contrib, torch.float32, dev))


def to_numpy(x):
    """Tensors -> numpy arrays, through NamedTuples, dataclasses, lists,
    tuples and dicts (NamedTuples keep their type; other leaves pass)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if hasattr(x, "stacked"):  # pipeline.StackedRecords
        return to_numpy(x.stacked)
    return x
