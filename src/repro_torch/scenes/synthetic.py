"""Procedural synthetic scenes (port of ``repro/scenes/synthetic.py``).

The same generators with the same statistics, drawn from a
``torch.Generator`` seeded with ``seed`` on the scene's device: the
numbers differ from the reference's ``jax.random`` draws, so parity
tests convert the reference's scenes instead (``repro_torch.interop``).

- ``random_blob_scene``  : isotropic-ish Gaussians in a box.
- ``structured_scene``   : an indoor-like room (large flat wall/floor
  Gaussians) plus dense high-frequency clutter clusters, the per-tile
  workload imbalance the paper exploits (Fig. 5).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.gaussians import GaussianScene, rgb_to_sh_dc


def _uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def random_blob_scene(seed: int, n: int, *, sh_degree: int = 0,
                      extent: float = 3.0, scale_range=(-3.5, -1.5),
                      depth_offset: float = 6.0,
                      device="cuda") -> GaussianScene:
    """n Gaussians uniform in a box centered ``depth_offset`` ahead."""
    g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    means = _uniform(g, (n, 3), -extent, extent)
    means[:, 2] += depth_offset
    log_scales = _uniform(g, (n, 3), *scale_range)
    quats = torch.randn((n, 4), generator=g, device=g.device)
    opacity_logits = _uniform(g, (n,), -1.0, 3.0)
    k_sh = (sh_degree + 1) ** 2
    sh = torch.zeros((n, k_sh, 3), device=g.device)
    sh[:, 0, :] = rgb_to_sh_dc(_uniform(g, (n, 3), 0.0, 1.0))
    if k_sh > 1:
        sh[:, 1:, :] = 0.1 * torch.randn((n, k_sh - 1, 3), generator=g,
                                         device=g.device)
    return GaussianScene(means, log_scales, quats, opacity_logits, sh)


def structured_scene(seed: int, n: int, *, sh_degree: int = 1,
                     clutter: float = 0.5, room: float = 4.0,
                     device="cuda") -> GaussianScene:
    """Room-like scene: walls/floor (few, large, flat) + clutter clusters."""
    g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dev = g.device
    n_flat = max(int(n * (1.0 - clutter) * 0.4), 16)
    n_clutter = n - n_flat

    # Flat structure: Gaussians pancaked onto 5 box faces. Faces: 0 floor
    # (y=+room), 1 back (z=2*room), 2 left (x=-room), 3 right (x=+room),
    # 4 ceiling (y=-room).
    face = torch.randint(0, 5, (n_flat,), generator=g, device=dev)
    uv = _uniform(g, (n_flat, 2), -room, room)
    fx = torch.where(face == 2, -room, torch.where(face == 3, room, uv[:, 0]))
    fy = torch.where(face == 0, room, torch.where(face == 4, -room, uv[:, 1]))
    fz = torch.where(face == 1, 2 * room,
                     room + _uniform(g, (n_flat,), 0.0, room))
    flat_means = torch.stack([fx, fy, fz], -1)
    # Pancake: large in-plane scale, tiny normal scale.
    thin = (torch.stack([face == 2, face == 0, face == 1], -1)
            | torch.stack([face == 3, face == 4, face == 1], -1))
    flat_scales = torch.where(thin, -4.0, -0.8)

    # Clutter: clusters of small splats.
    n_clusters = 12
    centers = _uniform(g, (n_clusters, 3), -0.7 * room, 0.7 * room)
    centers[:, 2] += 1.2 * room
    assign = torch.randint(0, n_clusters, (n_clutter,), generator=g,
                           device=dev)
    jitter = torch.randn((n_clutter, 3), generator=g, device=dev) \
        * (0.15 * room)
    clutter_means = centers[assign] + jitter
    clutter_scales = _uniform(g, (n_clutter, 3), -4.5, -2.5)

    means = torch.cat([flat_means, clutter_means], 0)
    log_scales = torch.cat([flat_scales, clutter_scales], 0)
    quats = torch.randn((n, 4), generator=g, device=dev)
    opacity_logits = torch.cat([
        torch.full((n_flat,), 2.5, device=dev),        # walls: near-opaque
        _uniform(g, (n_clutter,), -1.0, 2.5)])

    k_sh = (sh_degree + 1) ** 2
    flat_rgb = _uniform(g, (1, 3), 0.4, 0.8).expand(n_flat, 3) \
        + 0.05 * torch.randn((n_flat, 3), generator=g, device=dev)
    clutter_rgb = torch.rand((n_clutter, 3), generator=g, device=dev)
    rgbs = torch.clamp(torch.cat([flat_rgb, clutter_rgb], 0), 0.05, 0.95)
    sh = torch.zeros((n, k_sh, 3), device=dev)
    sh[:, 0, :] = rgb_to_sh_dc(rgbs)
    if k_sh > 1:
        sh[:, 1:, :] = 0.08 * torch.randn((n, k_sh - 1, 3), generator=g,
                                          device=dev)
    return GaussianScene(means, log_scales, quats, opacity_logits, sh)
