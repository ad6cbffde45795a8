"""Open-loop venue: many viewers served by one ``StreamServer``.

``viewers`` headsets each send a pose at fixed ticks of the wall clock,
whatever the server does: the offered load is ``offered_frames_per_s``
over all viewers, each viewer's ticks ``viewers / rate`` apart and the
viewers' first ticks staggered across one period. A viewer's session is
``session_poses`` long; when it ends the next viewer's session starts at
the following tick with a new trajectory (``scene.Sessions``), so
attach, detach and phase assignment run inside the window. At the start
of the window every viewer is part-way through its first session
(viewer ``v`` skips the first ``v / viewers`` of it).

Each pose goes to ``StreamSession.submit(pose, now=due)`` at the loop's
first pass at or after its due time. A frame's latency runs from its due
time to the end of the ``step()`` that rendered it. After the window no
pose is submitted; the backlog drains, so every frame due in the window
counts. A pose the server refuses counts as failed.

Every served frame is kept with the slot it was rendered in. The check
takes key-frame windows drawn from the seed: for each slot that rendered
a frame, one window holding a frame of that slot, then more at random up
to ``check_windows``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lsbench import devtrace
from lsbench.scene import Sessions, scene_and_camera


@dataclasses.dataclass
class Viewer:
    sessions: Sessions
    first_tick: float
    skip: float                 # share of the first session already seen
    session: Optional[object] = None
    served: Optional["Served"] = None
    poses: Optional[np.ndarray] = None
    k: int = 0                  # next pose of the session
    n: int = 0                  # next tick


@dataclasses.dataclass
class Served:
    """One session as the benchmark saw it."""

    sess: object
    poses: np.ndarray
    due: List[float]
    seen: int = 0
    capacity: List[int] = dataclasses.field(default_factory=list)
    slots: List[int] = dataclasses.field(default_factory=list)
    done_at: List[float] = dataclasses.field(default_factory=list)
    frames: List[torch.Tensor] = dataclasses.field(default_factory=list)


def make_server(scene, cam, cfg: dict, mix: dict, device):
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.serve.server import ServeConfig, StreamServer
    rcfg = RenderConfig(**{**cfg["render"], "impl": mix["impl"]})
    scfg = ServeConfig(chunk=mix["chunk"], b_buckets=tuple(mix["b_buckets"]),
                       r_buckets=tuple(mix["r_buckets"]),
                       adapt_every=mix["adapt_every"],
                       scene_buckets=(scene.means.shape[0],),
                       collect_frames=True)
    return StreamServer(scene, cam, rcfg, scfg, device=device)


def warm_up(srv, mix: dict) -> None:
    """Serve two short sessions at each re-render capacity R."""
    sessions = Sessions(mix, stream=99)
    window = srv.base_cfg.window
    for r in mix["r_buckets"]:
        srv.capacity = int(r)
        for _ in range(2):
            srv.attach(sessions.next()[:window + 1])
        while srv.manager.sessions:
            srv.step()
    devtrace.sync()


class Venue:
    """The open loop over one server (module docstring)."""

    def __init__(self, srv, mix: dict, rate: float):
        self.srv = srv
        self.mix = mix
        self.rate = float(rate)
        v = int(mix["viewers"])
        self.period = v / self.rate
        t0 = srv.clock()
        self.viewers = [Viewer(Sessions(mix, stream=10 + i),
                               t0 + i * self.period / v, i / v)
                        for i in range(v)]
        self.served: List[Served] = []
        self.refused: List[float] = []   # due times the server refused
        self.rounds = 0

    def _tick(self, vw: Viewer) -> float:
        return vw.first_tick + vw.n * self.period

    def submit_due(self, now: float) -> None:
        for vw in self.viewers:
            while self._tick(vw) <= now:
                due = self._tick(vw)
                vw.n += 1
                if vw.poses is None or vw.k == vw.poses.shape[0]:
                    poses = vw.sessions.next()
                    if vw.skip:
                        poses = poses[int(vw.skip * poses.shape[0]):]
                        vw.skip = 0.0
                    vw.poses, vw.k = poses, 0
                    vw.session = self.srv.try_attach(poses[:1], now=due)
                    if vw.session is not None:
                        vw.session.closed = False
                        vw.served = Served(vw.session, poses, [due])
                        self.served.append(vw.served)
                elif vw.session is not None:
                    vw.session.submit(vw.poses[vw.k:vw.k + 1], now=due)
                    vw.served.due.append(due)
                if vw.session is None:
                    self.refused.append(due)
                vw.k += 1
                if vw.k == vw.poses.shape[0] and vw.session is not None:
                    vw.session.closed = True

    def pending(self) -> bool:
        return any(s.pending for s in self.srv.manager.sessions.values())

    def backlog(self, now: float) -> int:
        """Frames due by ``now`` and not yet rendered (refused ones left
        out): submits what is due first, as the loop's next pass would."""
        self.submit_due(now)
        return sum(sum(1 for d in s.due if d <= now) - len(s.done_at)
                   for s in self.served)

    def step(self) -> None:
        r = self.srv.capacity
        # A session the round finishes is unbound in it: its frames were
        # rendered in the slot it held before the round.
        held = [s.sess.slot for s in self.served]
        self.srv.step()
        done = self.srv.clock()
        self.rounds += 1
        for s, before in zip(self.served, held):
            new = s.sess.frames_rendered - s.seen
            if new:
                slot = s.sess.slot if s.sess.slot is not None else before
                s.done_at += [done] * new
                s.capacity += [r] * new
                s.slots += [-1 if slot is None else int(slot)] * new
                s.seen += new
            if s.sess.frames:
                s.frames += s.sess.frames
                s.sess.frames.clear()

    def serve(self, until: float, submit: bool = True,
              rounds: Optional[int] = None) -> None:
        """Serve until the clock passes ``until`` (or ``rounds`` rounds)."""
        start = self.rounds
        while True:
            now = self.srv.clock()
            if now >= until or (rounds is not None
                                and self.rounds - start >= rounds):
                return
            if submit:
                self.submit_due(now)
            if self.pending():
                self.step()
            elif submit:
                nxt = min(self._tick(vw) for vw in self.viewers)
                time.sleep(max(0.0, min(nxt, until) - self.srv.clock()))
            else:
                return

    def close(self) -> None:
        for vw in self.viewers:
            if vw.session is not None:
                vw.session.closed = True

    def drain(self) -> None:
        self.close()
        while self.pending():
            self.step()


def counters(srv) -> Dict[str, float]:
    return dict(active=srv.active_slot_frames,
                capacity=srv.capacity_frames,
                render_s=srv.render_seconds, busy=srv.busy_rounds)


def latencies(venue: Venue, t_end: float):
    """(latency seconds of every frame due before ``t_end`` that was
    rendered, frames due before ``t_end`` (refused ones too), frames
    completed by ``t_end``)."""
    lat, done_n = [], 0
    due_n = sum(1 for d in venue.refused if d < t_end)
    for s in venue.served:
        for i, d in enumerate(s.due):
            if d < t_end:
                due_n += 1
                if i < len(s.done_at):
                    lat.append(s.done_at[i] - d)
        done_n += sum(1 for t in s.done_at if t <= t_end)
    return lat, due_n, done_n


def run(cell) -> dict:
    cfg, mix = cell.config, cell.mix
    scene, cam = scene_and_camera(cfg, cell.seed, cell.device)
    rng = np.random.default_rng([cell.seed % 2 ** 63, 7])
    cell.mark("scene")
    warm_up(make_server(scene, cam, cfg, mix, cell.device), mix)
    cell.mark("warm-up")

    srv = make_server(scene, cam, cfg, mix, cell.device)
    venue = Venue(srv, mix, mix["offered_frames_per_s"])
    t_start = srv.clock()
    setup_s = t_start - cell.t_process
    before = counters(srv)
    venue.serve(t_start + cell.seconds)
    t_end = t_start + cell.seconds
    after = counters(srv)
    out = {}
    obs = dict(slot_occupancy=(after["active"] - before["active"])
               / max(after["capacity"] - before["capacity"], 1),
               round_s=(after["render_s"] - before["render_s"])
               / max(after["busy"] - before["busy"], 1),
               kind="venue")
    if cell.trace:
        _, sl = devtrace.profiled(lambda: venue.serve(
            float("inf"), rounds=int(mix["trace_rounds"])))
        obs["slice"] = sl
        out.update(busy_s=sl.busy_s, window_s=sl.wall_s,
                   breakdown=devtrace.breakdown(sl))
    venue.drain()
    lat, due_n, done_n = latencies(venue, t_end)
    out.update(
        e2e=dict(frames_per_s=done_n / cell.seconds,
                 serve_latency_ms_p95=float(np.percentile(lat, 95)) * 1e3
                 if lat else float("inf"),
                 setup_s=setup_s),
        frames=done_n, attempted=due_n, failed=due_n - len(lat),
        memory_peak_bytes=cell.memory_peak(), obs=obs, scene=scene,
        venue=venue)
    out["checked"] = checked_windows(venue.served, srv.base_cfg.window, rng,
                                     int(mix["check_windows"]))
    for s in venue.served:
        s.frames = []
    return out


def key_windows(s: Served, window: int):
    """(first, end) frame indices of each key-frame window of a served
    session, as far as it rendered."""
    n = s.seen
    keys = [i for i in range(n) if i == 0 or (i + s.sess.phase) % window == 0]
    return list(zip(keys, keys[1:] + [n]))


def checked_windows(served: List[Served], window: int, rng, count: int):
    """Key-frame windows drawn for the check (module docstring): lists of
    frames (rgb, pose, is key, R) from a key frame to the frame before the
    next."""
    wins = [(s, lo, hi) for s in served if s.frames
            for lo, hi in key_windows(s, window)]
    picked: List[int] = []
    for slot in sorted({x for s in served for x in s.slots if x >= 0}):
        if any(slot in wins[i][0].slots[wins[i][1]:wins[i][2]]
               for i in picked):
            continue
        holds = [i for i, (s, lo, hi) in enumerate(wins)
                 if slot in s.slots[lo:hi]]
        picked.append(holds[int(rng.integers(len(holds)))])
    rest = [i for i in range(len(wins)) if i not in picked]
    more = rng.choice(len(rest), size=min(max(count - len(picked), 0),
                                          len(rest)), replace=False)
    picked += [rest[int(i)] for i in more]
    out, frames_of = [], {}
    for i in sorted(picked):
        s, lo, hi = wins[i]
        if id(s) not in frames_of:
            frames_of[id(s)] = torch.cat(s.frames)
        frames = frames_of[id(s)]
        out.append([dict(rgb=frames[j], pose=s.poses[j], key=j == lo,
                         capacity=s.capacity[j]) for j in range(lo, hi)])
    return out
