"""Pinhole camera model and pose utilities (port of ``repro/core/camera.py``).

Intrinsics and image size are Python numbers; the world-to-camera pose
is a (4, 4) float32 tensor, and its device is the camera's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device

TILE = 16  # 16x16-pixel tiles, as in the paper (Sec. II-A)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. ``w2c`` maps world -> camera (x right, y down, +z fwd)."""

    w2c: torch.Tensor  # (4, 4) float32
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def tiles_x(self) -> int:
        return self.width // TILE

    @property
    def tiles_y(self) -> int:
        return self.height // TILE

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    def with_pose(self, w2c: torch.Tensor) -> "Camera":
        return dataclasses.replace(self, w2c=w2c)


def make_camera(w2c, *, width: int, height: int, fov_deg: float = 60.0,
                device="cuda") -> Camera:
    """Square-pixel camera from a vertical FOV."""
    if width % TILE or height % TILE:
        raise ValueError(f"image size must be a multiple of {TILE}")
    f = 0.5 * height / float(np.tan(np.radians(fov_deg) / 2.0))
    w2c = torch.as_tensor(w2c, dtype=torch.float32,
                          device=resolve_device(device))
    return Camera(w2c=w2c, fx=f, fy=f, cx=width / 2.0, cy=height / 2.0,
                  width=width, height=height)


def look_at(eye, target, up=(0.0, 1.0, 0.0), *, device="cuda"
            ) -> torch.Tensor:
    """World-to-camera matrix looking from ``eye`` at ``target``. (4, 4)."""
    dev = resolve_device(device)
    eye = torch.as_tensor(eye, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    up = torch.as_tensor(up, dtype=torch.float32, device=dev)
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / (torch.linalg.norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right)  # y points down in camera frame
    rot = torch.stack([right, down, fwd], dim=0)  # (3, 3) world->cam
    w2c = torch.eye(4, dtype=torch.float32, device=dev)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ eye
    return w2c


def camera_position(cam: Camera) -> torch.Tensor:
    """Camera center in world coordinates. (3,)."""
    rot = cam.w2c[:3, :3]
    return -rot.T @ cam.w2c[:3, 3]


def cam_to_world(cam: Camera) -> torch.Tensor:
    """(4, 4) inverse pose."""
    rot = cam.w2c[:3, :3]
    c2w = torch.eye(4, dtype=cam.w2c.dtype, device=cam.device)
    c2w[:3, :3] = rot.T
    c2w[:3, 3] = -rot.T @ cam.w2c[:3, 3]
    return c2w


def pixel_grid(cam: Camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates (u, v), each (H, W)."""
    u = torch.arange(cam.width, dtype=torch.float32, device=cam.device) + 0.5
    v = torch.arange(cam.height, dtype=torch.float32, device=cam.device) + 0.5
    return torch.meshgrid(u, v, indexing="xy")


def backproject(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Lift every pixel to world space using per-pixel depth.

    depth: (H, W) positive camera-z depth. Returns (H, W, 3) world points.
    """
    u, v = pixel_grid(cam)
    x = (u - cam.cx) / cam.fx * depth
    y = (v - cam.cy) / cam.fy * depth
    pts_cam = torch.stack([x, y, depth], dim=-1)            # (H, W, 3)
    rot = cam.w2c[:3, :3]
    return (pts_cam - cam.w2c[:3, 3]) @ rot  # == rot.T @ (p - t), batched


def project(cam: Camera, pts_world: torch.Tensor):
    """World points -> (u, v, depth). pts_world: (..., 3)."""
    rot, t = cam.w2c[:3, :3], cam.w2c[:3, 3]
    pc = pts_world @ rot.T + t
    z = pc[..., 2]
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    return u, v, z
