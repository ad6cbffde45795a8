"""Device placement of stream slots (port of ``repro/serve/placement.py``).

The reference shard_maps the masked stream scan over a 1-D "streams"
mesh: each device renders its B/D contiguous slots, gathers only the
scenes its slots name from the replicated stack, and with one local slot
runs the stream scan without vmap. Here a mesh is a tuple of torch
devices (``stream_mesh``), and ``build_render_fn(cam, cfg, mesh)``
splits the B slots into D contiguous groups of B/D, in slot order. Each
group's camera, poses, counts, phases and carries go to its device; a
multi-scene group takes only the scenes its ``slot_scene`` entries name
(each scene is copied to a device once, on first use, and the copy is
dropped with the scene); a group of one slot runs ``engine.stream_scan``
itself (the reference's single-local-stream branch); the results come
back to the mesh's first device in slot order as one ``StreamsResult``,
equal to the plain path's.

Groups on distinct devices run concurrently, one host thread per device:
the port's frames sync the host several times each (``core/pipeline.py``,
``core/warp.py``), so one thread would serialise the devices at every
sync. Groups that share a device run one after another: a mesh may
repeat a device, as the CPU tests do with ``("cpu",) * D`` and a one-card
host with ``(cuda:0,) * D``, and which device a group lands on changes
no result. A group that fails raises; nothing falls back to another
device or to the plain path.

``stream_mesh`` returns None where only one device divides the slots, and
the caller then renders through the plain ``engine.render_streams`` (the
reference's degrade; the server's ``report()`` shows it as
``num_devices`` 1).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.camera import Camera
from repro_torch.core.engine import EngineCarry, StreamsResult
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.pipeline import (FrameState, RenderConfig,
                                       StackedRecords, stack_fields)


def stream_mesh(num_slots: int, devices: Optional[Sequence] = None
                ) -> Optional[Tuple[torch.device, ...]]:
    """The most of ``devices`` (default: every CUDA device) that divide
    ``num_slots``, as a tuple; None when that is one device or none (the
    caller renders on one device). ``devices`` may repeat a device."""
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


class _SceneCopies:
    """Each scene's copy on each device, made on first use and dropped
    when the scene's tensors are (keyed by its ``means`` tensor)."""

    def __init__(self):
        self._copies: Dict[tuple, tuple] = {}

    def get(self, scene: GaussianScene, dev: torch.device) -> GaussianScene:
        if scene.means.device == dev:
            return scene
        key = (id(scene.means), dev)
        hit = self._copies.get(key)
        if hit is not None and hit[0]() is scene.means:
            return hit[1]
        copy = GaussianScene(*(t.to(dev) for t in scene))
        self._copies[key] = (weakref.ref(scene.means), copy)
        weakref.finalize(scene.means, self._copies.pop, key, None)
        return copy


def _device_context(dev: torch.device):
    """Kernels launch on the thread's current CUDA device."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _rows(carries: EngineCarry, lo: int, hi: int,
          dev: torch.device) -> EngineCarry:
    """Slots ``lo:hi`` of a stacked carry, on ``dev``."""
    return EngineCarry(
        state=FrameState(*(None if f is None else f[lo:hi].to(dev)
                           for f in carries.state)),
        prev_pose=carries.prev_pose[lo:hi].to(dev),
        step=torch.as_tensor(carries.step)[lo:hi].to(dev))


def _cat(items: List, dev: torch.device):
    """NamedTuples of (b_i, ...) tensors -> one of (sum b_i, ...) on
    ``dev``, field by field (None fields stay None)."""
    first = items[0]
    return type(first)(*(
        None if getattr(first, f) is None
        else torch.cat([getattr(x, f).to(dev) for x in items])
        for f in first._fields))


def _run_by_device(jobs: List[tuple], fn) -> List:
    """``fn(*job)`` for every job (its first entry is its device), in
    job order: serially per device, concurrently across devices."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, job in enumerate(jobs):
        by_dev.setdefault(job[0], []).append(i)

    def serial(idx):
        return [fn(*jobs[i]) for i in idx]

    if len(by_dev) == 1:
        return serial(range(len(jobs)))
    out: List = [None] * len(jobs)
    with ThreadPoolExecutor(max_workers=len(by_dev)) as pool:
        futures = [(idx, pool.submit(serial, idx)) for idx in by_dev.values()]
        for idx, fut in futures:
            for i, res in zip(idx, fut.result()):
                out[i] = res
    return out


def build_render_fn(cam: Camera, cfg: RenderConfig,
                    mesh: Optional[Sequence] = None, *,
                    multi_scene: bool = False):
    """The serving layer's render entry point.

    ``multi_scene=False``:
    ``fn(scene, poses, counts, phases, carries) -> StreamsResult``.
    ``multi_scene=True``:
    ``fn(scenes, poses, counts, phases, carries, slot_scene)`` with
    ``scenes`` a sequence of scenes and ``slot_scene`` (B,) int32.

    Without a mesh, ``engine.render_streams`` on the inputs' device. With
    a mesh of D devices (``stream_mesh``), B/D contiguous slots on each
    device (module docstring); B must divide by D.
    """
    if mesh is None:
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

    devices = tuple(torch.device(d) for d in mesh)
    cams = {d: dataclasses.replace(cam, w2c=cam.w2c.to(d))
            for d in set(devices)}
    copies = _SceneCopies()

    def render_group(dev, lo, hi, scenes, ids, poses, counts, phases,
                     carries):
        """Slots ``lo:hi`` on ``dev``: (carries, frames, records (stacked
        FrameRecord), frame_active), each with a leading slot dim."""
        gcam = cams[dev]
        local = sorted(set(ids))
        gscenes = [copies.get(scenes[i], dev) for i in local]
        gids = [local.index(i) for i in ids]
        gposes = poses[lo:hi].to(dev)
        gcounts = counts[lo:hi].to(dev)
        gphases = phases[lo:hi].to(dev)
        gcarries = _rows(carries, lo, hi, dev)
        with _device_context(dev):
            if hi - lo == 1:
                end, (frames, recs, active) = engine.stream_scan(
                    gscenes[gids[0]], gcam, gposes[0], int(gcounts[0]),
                    int(gphases[0]), cfg,
                    engine.unstack_carries(gcarries)[0])
                return (engine.stack_carries([end]), frames[None],
                        stack_fields([recs.stacked]), active[None])
            res = engine.render_streams(
                gscenes if multi_scene else gscenes[0], gcam, gposes, cfg,
                phases=gphases, counts=gcounts, carries=gcarries,
                slot_scene=torch.tensor(gids, dtype=torch.int32, device=dev)
                if multi_scene else None)
            return res.carries, res.frames, res.records.stacked, \
                res.frame_active

    def split(scenes, poses, counts, phases, carries, slot_scene):
        b, d = poses.shape[0], len(devices)
        if b % d:
            raise ValueError(f"{b} slots do not split over {d} devices")
        g = b // d
        counts = torch.as_tensor(counts, dtype=torch.int32)
        phases = torch.as_tensor(phases, dtype=torch.int32)
        ids = [0] * b if slot_scene is None \
            else torch.as_tensor(slot_scene).tolist()
        jobs = [(dev, k * g, (k + 1) * g, scenes, ids[k * g:(k + 1) * g],
                 poses, counts, phases, carries)
                for k, dev in enumerate(devices)]
        parts = _run_by_device(jobs, render_group)
        out = devices[0]
        carry = EngineCarry(
            state=_cat([p[0].state for p in parts], out),
            prev_pose=torch.cat([p[0].prev_pose.to(out) for p in parts]),
            step=torch.cat([p[0].step.to(out) for p in parts]))
        return StreamsResult(
            frames=torch.cat([p[1].to(out) for p in parts]),
            records=StackedRecords(_cat([p[2] for p in parts], out)),
            phases=phases.to(out), counts=counts.to(out),
            frame_active=torch.cat([p[3].to(out) for p in parts]),
            carries=carry)

    if multi_scene:
        return split

    def fn(scene, poses, counts, phases, carries):
        return split((scene,), poses, counts, phases, carries, None)
    return fn
