"""Camera trajectories simulating the paper's 90 FPS setup (port of
``repro/scenes/trajectory.py``).

Paper Sec. VI-A: camera motion at 1.8 m/s and 90 degrees per second
rendered at 90 FPS -> per-frame deltas of 2 cm and 1 degree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.camera import look_at

FPS = 90.0
SPEED_M_S = 1.8
ROT_DEG_S = 90.0


def orbit_trajectory(n_frames: int, *, radius: float = 6.0,
                     target=(0.0, 0.0, 6.0), height: float = -0.5,
                     fps: float = FPS, rot_deg_s: float = ROT_DEG_S,
                     device="cuda") -> torch.Tensor:
    """Orbit around ``target`` at the paper's angular speed. (F, 4, 4)."""
    dev = resolve_device(device)
    d_theta = np.radians(rot_deg_s / fps)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    poses = []
    for th in np.arange(n_frames) * d_theta:
        eye = target + radius * torch.tensor(
            [np.sin(th), 0.0, -np.cos(th)], dtype=torch.float32, device=dev)
        eye[1] += height
        poses.append(look_at(eye, target, device=dev))
    return torch.stack(poses)


def dolly_trajectory(n_frames: int, *, start=(0.0, -0.3, 0.0),
                     target=(0.0, 0.0, 8.0), fps: float = FPS,
                     speed: float = SPEED_M_S, lateral: float = 0.35,
                     device="cuda") -> torch.Tensor:
    """Forward dolly with gentle lateral sway — a corridor walkthrough."""
    dev = resolve_device(device)
    step = speed / fps
    start = torch.as_tensor(start, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    fwd = target - start
    fwd = fwd / torch.linalg.norm(fwd)
    poses = []
    for i in range(n_frames):
        sway = lateral * np.sin(2.0 * np.pi * i / 180.0)
        eye = start + fwd * (step * i) + torch.tensor(
            [sway, 0.0, 0.0], dtype=torch.float32, device=dev)
        poses.append(look_at(eye, target, device=dev))
    return torch.stack(poses)
