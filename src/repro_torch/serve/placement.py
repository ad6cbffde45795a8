"""Device placement of stream slots (port of ``repro/serve/placement.py``).

The reference shard_maps the masked stream scan over a 1-D "streams" mesh
so that each device renders only its B/D slots. On one device it falls
back to the plain ``render_streams``, and so does the port: the engine's
stream loop already runs only the branch each stream takes, which was
the reference's other reason to shard. Splitting slots over several
cards is not ported yet (ROADMAP.md): ``build_render_fn`` renders every
slot on one device, and ``stream_mesh`` only says how the reference
would split them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.camera import Camera
from repro_torch.core.pipeline import RenderConfig


def stream_mesh(num_slots: int, devices: Optional[Sequence] = None
                ) -> Optional[Tuple[torch.device, ...]]:
    """The most CUDA devices that divide ``num_slots``; None when that is
    one device or none (the caller renders on one device)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    d = min(len(devices), int(num_slots))
    while d > 1 and num_slots % d:
        d -= 1
    if d <= 1:
        return None
    return tuple(devices[:d])


def build_render_fn(cam: Camera, cfg: RenderConfig, *,
                    multi_scene: bool = False):
    """The serving layer's render entry point.

    ``multi_scene=False``:
    ``fn(scene, poses, counts, phases, carries) -> StreamsResult``.
    ``multi_scene=True``:
    ``fn(scenes, poses, counts, phases, carries, slot_scene)`` with
    ``scenes`` a sequence of scenes and ``slot_scene`` (B,) int32.
    Both are ``engine.render_streams`` on the scenes' device.
    """
    if multi_scene:
        def fn(scenes, poses, counts, phases, carries, slot_scene):
            return engine.render_streams(
                scenes, cam, poses, cfg, phases=phases, counts=counts,
                carries=carries, slot_scene=slot_scene)
    else:
        def fn(scene, poses, counts, phases, carries):
            return engine.render_streams(scene, cam, poses, cfg,
                                         phases=phases, counts=counts,
                                         carries=carries)
    return fn
