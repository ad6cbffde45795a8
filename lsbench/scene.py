"""Scenes and poses the benchmark makes from a seed.

``structured_scene`` keeps the statistics of the program's synthetic
room scene (``scenes/synthetic.py``): a room of large flat Gaussians
(walls, floor, ceiling) and dense clutter in twelve clusters, with SH
colour. The room's layout (cluster centres, wall colour) comes from the
configuration's ``layout_seed``, so every run seed renders the same kind
of view; every Gaussian's own draw comes from the run seed. It is drawn
on the device by a ``torch.Generator`` there, in a few large calls.

The poses follow the paper's motion (Sec. VI-A): 90 Hz spacing, a 1.8
m/s dolly with lateral sway and a 90 deg/s orbit (the program's
``scenes/trajectory.py`` and ``serve/server.sample_trajectory``),
computed in numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

SH_C0 = 0.28209479177387814
GOLDEN = (5 ** 0.5 - 1) / 2


def _uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def structured_scene(seed: int, n: int, *, layout_seed: int,
                     sh_degree: int = 3, clutter: float = 0.5,
                     room: float = 4.0, device="cuda"):
    """(means, log_scales, quats, opacity_logits, sh) of ``n`` Gaussians."""
    dev = torch.device(device)
    lay = torch.Generator(device=dev).manual_seed(int(layout_seed))
    g = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 63)
    n_flat = max(int(n * (1.0 - clutter) * 0.4), 16)
    n_clutter = n - n_flat
    n_clusters = 12
    centers = _uniform(lay, (n_clusters, 3), -0.7 * room, 0.7 * room)
    centers[:, 2] += 1.2 * room
    wall_rgb = _uniform(lay, (1, 3), 0.4, 0.8)

    face = torch.randint(0, 5, (n_flat,), generator=g, device=dev)
    uv = _uniform(g, (n_flat, 2), -room, room)
    fx = torch.where(face == 2, -room, torch.where(face == 3, room, uv[:, 0]))
    fy = torch.where(face == 0, room, torch.where(face == 4, -room, uv[:, 1]))
    fz = torch.where(face == 1, 2 * room,
                     room + _uniform(g, (n_flat,), 0.0, room))
    thin = (torch.stack([face == 2, face == 0, face == 1], -1)
            | torch.stack([face == 3, face == 4, face == 1], -1))
    assign = torch.randint(0, n_clusters, (n_clutter,), generator=g,
                           device=dev)
    jitter = torch.randn((n_clutter, 3), generator=g, device=dev) \
        * (0.15 * room)
    means = torch.cat([torch.stack([fx, fy, fz], -1),
                       centers[assign] + jitter], 0)
    log_scales = torch.cat([torch.where(thin, -4.0, -0.8),
                            _uniform(g, (n_clutter, 3), -4.5, -2.5)], 0)
    quats = torch.randn((n, 4), generator=g, device=dev)
    opacity_logits = torch.cat([torch.full((n_flat,), 2.5, device=dev),
                                _uniform(g, (n_clutter,), -1.0, 2.5)])
    rgb = torch.cat([
        wall_rgb.expand(n_flat, 3)
        + 0.05 * torch.randn((n_flat, 3), generator=g, device=dev),
        torch.rand((n_clutter, 3), generator=g, device=dev)], 0)
    k_sh = (sh_degree + 1) ** 2
    sh = torch.zeros((n, k_sh, 3), device=dev)
    sh[:, 0, :] = (torch.clamp(rgb, 0.05, 0.95) - 0.5) / SH_C0
    if k_sh > 1:
        sh[:, 1:, :] = 0.08 * torch.randn((n, k_sh - 1, 3), generator=g,
                                          device=dev)
    return means, log_scales, quats, opacity_logits, sh


def scene_and_camera(cfg: dict, seed: int, device):
    """The program's ``GaussianScene`` of configuration ``cfg`` drawn from
    ``seed``, and its camera."""
    from repro_torch.core.camera import make_camera
    from repro_torch.core.gaussians import GaussianScene
    scene = GaussianScene(*structured_scene(
        seed, cfg["num_gaussians"], layout_seed=cfg["layout_seed"],
        sh_degree=cfg["sh_degree"], device=device))
    cam = make_camera(np.eye(4, dtype=np.float32), width=cfg["resolution_x"],
                      height=cfg["resolution_y"], fov_deg=cfg["fov_deg"],
                      device=device)
    return scene, cam


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-to-camera (4, 4) float32: x right, y down, +z forward."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd) + 1e-12
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right) + 1e-12
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    w2c = np.eye(4)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ eye
    return w2c.astype(np.float32)


def orbit(n: int, *, radius: float, target, height: float, theta0: float,
          fps: float, rot_deg_s: float) -> np.ndarray:
    """(n, 4, 4) poses orbiting ``target`` at ``rot_deg_s``."""
    target = np.asarray(target, np.float64)
    step = np.radians(rot_deg_s / fps)
    out = []
    for th in theta0 + np.arange(n) * step:
        eye = target + radius * np.array([np.sin(th), 0.0, -np.cos(th)])
        eye[1] += height
        out.append(look_at(eye, target))
    return np.stack(out)


def dolly(n: int, *, start, target, fps: float, speed: float,
          lateral: float = 0.35) -> np.ndarray:
    """(n, 4, 4) poses of a forward dolly with a gentle lateral sway."""
    start = np.asarray(start, np.float64)
    target = np.asarray(target, np.float64)
    fwd = (target - start) / np.linalg.norm(target - start)
    out = []
    for i in range(n):
        sway = lateral * np.sin(2.0 * np.pi * i / 180.0)
        eye = start + fwd * (speed / fps * i) + np.array([sway, 0.0, 0.0])
        out.append(look_at(eye, target))
    return np.stack(out)


class Sessions:
    """An endless sequence of viewer sessions drawn from a traffic mix.

    Session ``i`` of viewer ``stream`` takes its length (``session_poses``
    [lo, hi]), its kind (orbit or dolly, by ``orbit_share``) and its start
    from a golden-ratio sequence of the viewer. Every seed renders the
    same sessions in the same order: a run's window then holds the same
    work whatever the seed, which draws the scene's Gaussians and the
    checked windows. (With the order drawn from the seed, which kind of
    session the window ended in moved ``frames_per_s`` by 13 % between
    seeds.) ``mix`` also holds ``fps``, ``speed_m_s`` and ``rot_deg_s``.
    """

    TARGET = (0.0, 0.0, 6.0)

    def __init__(self, mix: dict, stream: int = 0):
        self.mix = mix
        self.u = np.random.default_rng([int(stream), 20250729]).random(5)
        self.j = 0

    def _frac(self, i: int, c: int) -> float:
        return float((self.u[c] + GOLDEN * (i + 1) * (c + 1)) % 1.0)

    def next(self) -> np.ndarray:
        m = self.mix
        i = self.j
        self.j += 1
        lo, hi = m["session_poses"]
        n = lo + int(round(self._frac(i, 0) * (hi - lo)))
        share = float(m["orbit_share"])
        if np.floor((i + 1) * share) > np.floor(i * share):
            return orbit(n, radius=5.0 + 3.0 * self._frac(i, 2),
                         target=self.TARGET, height=-self._frac(i, 3),
                         theta0=np.pi / 2 * (self._frac(i, 4) - 0.5),
                         fps=m["fps"], rot_deg_s=m["rot_deg_s"])
        return dolly(n, start=(0.8 * self._frac(i, 2) - 0.4,
                               0.5 * self._frac(i, 3) - 0.4,
                               -3.0 + 1.5 * self._frac(i, 4)),
                     target=self.TARGET, fps=m["fps"], speed=m["speed_m_s"])
