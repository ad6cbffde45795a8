"""Closed-loop single viewer: one camera stream rendered frame after frame.

The viewer's sessions (``scene.Sessions``) are chained end to end; each
session starts a fresh stream (a key frame) and goes through the
program's entry ``core.engine.make_frame_step``: a key frame every
``window`` frames, TWSR warped frames in between. Each frame is timed on
the host clock from the step's call to the ``torch.cuda.synchronize()``
after it, and the next frame starts when it is done.

Key-frame windows are numbered as they start; every ``check_every``-th
(from an offset the seed picks) keeps its frames and records for the
check that follows the measured window.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from lsbench import devtrace
from lsbench.scene import Sessions, scene_and_camera


class Viewer:
    """The program's frame step driven over a chain of sessions."""

    def __init__(self, scene, cam, rcfg, mix, stream=0):
        from repro_torch.core import engine
        self.engine = engine
        self.cam = cam
        self.window = rcfg.window
        self.step = engine.make_frame_step(scene, cam, rcfg)
        self.sessions = Sessions(mix, stream)
        self.poses = None
        self.i = 0
        self.carry = None
        self.windows = -1   # key-frame windows started so far, less one

    def next_pose(self):
        if self.poses is None or self.i == self.poses.shape[0]:
            host = self.sessions.next()
            self.poses = torch.as_tensor(host, device=self.cam.device)
            self.host = host
            self.i = 0
            self.carry = self.engine.init_carry(self.cam, self.poses[0])
        if self.i % self.window == 0:
            self.windows += 1
        pose = self.poses[self.i]
        self.i += 1
        return pose

    def frame(self):
        """Render the next frame; returns (rgb, record, host pose, seconds,
        key-frame window index, is a key frame)."""
        pose = self.next_pose()
        at = self.i - 1
        t0 = time.perf_counter()
        self.carry, (rgb, rec) = self.step(self.carry, pose)
        devtrace.sync()
        return (rgb, rec, self.host[at], time.perf_counter() - t0,
                self.windows, at % self.window == 0)

    def to_window_start(self):
        """Render (untimed) until the next frame starts a key-frame
        window."""
        while self.poses is not None and self.i % self.window != 0 \
                and self.i < self.poses.shape[0]:
            self.frame()


def _kept(rgb, rec, pose, key):
    return dict(rgb=rgb, pose=pose, key=key,
                block_of_tile=rec.block_of_tile,
                order_in_block=rec.order_in_block,
                sort_pairs=rec.sort_pairs, raw_pairs=rec.raw_pairs,
                active=rec.active)


def run(cell) -> dict:
    from repro_torch.core.pipeline import RenderConfig
    cfg, mix = cell.config, cell.mix
    scene, cam = scene_and_camera(cfg, cell.seed, cell.device)
    rcfg = RenderConfig(**cfg["render"])
    cell.mark("scene")
    rng = np.random.default_rng([cell.seed % 2 ** 63, 7])
    every = int(mix["check_every"])
    offset = int(rng.integers(every))

    # Set-up: a throwaway session's first two key-frame windows.
    warm = Viewer(scene, cam, rcfg, mix, stream=1)
    for _ in range(2 * rcfg.window):
        warm.frame()
    del warm
    cell.mark("warm-up")

    viewer = Viewer(scene, cam, rcfg, mix)
    kept = {}
    times: List[float] = []
    t_start = time.perf_counter()
    setup_s = t_start - cell.t_process
    while True:
        rgb, rec, pose, sec, w, key = viewer.frame()
        times.append(sec)
        if (w + offset) % every == 0:
            kept.setdefault(w, []).append(_kept(rgb, rec, pose, key))
        if time.perf_counter() - t_start >= cell.seconds:
            break
    window_s = time.perf_counter() - t_start
    out = dict(
        e2e=dict(frames_per_s=len(times) / window_s,
                 frame_ms_p95=float(np.percentile(times, 95)) * 1e3,
                 setup_s=setup_s),
        frames=len(times), attempted=len(times), failed=0,
        memory_peak_bytes=cell.memory_peak())
    # A window the measured time cut short is still checked as far as it
    # went: its frames depend only on its own key frame.
    windows = sorted(kept)
    pick = rng.choice(len(windows), size=min(int(mix["check_windows"]),
                                             len(windows)), replace=False)
    checked = [kept[windows[i]] for i in sorted(pick)]
    kept.clear()

    obs = {}
    if cell.trace:
        viewer.to_window_start()
        slice_frames = []

        def traced():
            for _ in range(int(mix["trace_windows"]) * rcfg.window):
                rgb, rec, pose, sec, w, key = viewer.frame()
                slice_frames.append((w, _kept(rgb, rec, pose, key), sec))

        _, sl = devtrace.profiled(traced)
        viewer.to_window_start()
        _, syncs = devtrace.host_syncs(
            lambda: [viewer.frame() for _ in range(rcfg.window)])
        obs.update(slice=sl, slice_frames=slice_frames,
                   syncs=sum(syncs.values()), sync_frames=rcfg.window,
                   sync_sites=syncs, kind="stream")
        out.update(busy_s=sl.busy_s, window_s=sl.wall_s,
                   breakdown=devtrace.breakdown(sl))
    del viewer
    out["checked"] = checked
    out["obs"] = obs
    out["scene"] = scene
    return out
