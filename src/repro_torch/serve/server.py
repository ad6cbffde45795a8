"""The serve loop: scenes + sessions -> admission -> per-bucket batchers
(port of ``repro/serve/server.py``).

One ``StreamServer.step()`` is a ragged mixed-bucket round: the admission
controller (serve/admission.py) plans which scene buckets render this
round from per-bucket demand (aging bounds any bucket's wait; SLO classes
bias ordering and the elastic-B resize), then every planned bucket group
— one ``ContinuousBatcher`` per scene bucket — resizes, admits its
waiting streams, builds its (B, chunk) batch and renders it through its
cached render callable. A ``torch.cuda.synchronize`` on every device
the round rendered on closes the round, and all groups' carries commit
after it.

Placement (``ServeConfig.use_sharding``): each B gets its own slot split
(``placement.stream_mesh(B, devices)``, memoized per B): the render
callable splits the B slots over the split's D devices in contiguous
groups of B/D, and the batcher packs same-scene streams into those
groups (``group=B/D``), so a device's slots gather few scenes. ``devices``
defaults to the server's device followed by the host's other CUDA
devices; where one device divides B (a one-card host, or
``use_sharding=False``) every slot renders on the server's device and
``report()["num_devices"]`` is 1.

Overlap: the reference dispatches every group asynchronously and waits
once, so one bucket's device work overlaps the next group's host work.
In the port every frame still syncs the host once, where the intersect
reads its pair total to size the key buffer (``kernels/intersect_bin.py``),
so the groups of a round run one after another, host and device in turn.
The LDU schedule itself runs on the device (``kernels/ldu_fill.py``).

Scenes come from a ``SceneRegistry`` (serve/scenes.py): pass one with
scenes registered, or pass a bare ``GaussianScene`` and the server
registers it as the single default scene. Each group's distinct scenes
go to the engine as a tuple and every slot picks its own
(``slot_scene``), so any mix of same-bucket scenes shares one cache
entry: the key is ``(scene_bucket, B, chunk, R, window, impl)`` and
never names a scene.

Serving shapes adapt through ``cache.BucketPolicy``: R re-picks every
``adapt_every`` busy rounds from a rolling history of recorded re-render
demand; each bucket's B re-snaps every round from that bucket's
(SLO-weighted) queue depth. The distinct keys stay bounded by
``policy.max_keys`` per scene bucket in use, and ``evict_scene`` drops
the entries of a bucket that left use.

Backpressure: with ``AdmissionConfig.max_waiting`` set, ``attach``
raises ``AdmissionRejected`` once the waiting set is full (``try_attach``
returns None; ``run`` defers the arrival and retries next round).
``report()`` publishes per-bucket p50/p99 latency, per-bucket max wait
and a Jain fairness index over service shares next to the global
metrics.

``sim_latency=True`` folds every rendered frame's ``FrameRecord`` (with
its recorded LDU schedule) into a bounded trace that ``report()`` replays
through ``core/streaming.simulate_sequence(policy="recorded")``.

Traffic: ``PoissonTraffic`` (Poisson arrivals of dolly/orbit
trajectories round-robined over scenes) and ``ReplayTraffic`` (a
deterministic arrival trace: ``skewed_trace``, ``burst_trace``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import (Deque, Dict, List, Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.pipeline import (FrameRecord, RenderConfig,
                                       StackedRecords, contrib_enabled)
from repro_torch.core.plan import rerender_demand
from repro_torch.core.streaming import (AcceleratorConfig, FrameWork,
                                        frameworks_from_stacked,
                                        simulate_sequence, throughput)
from repro_torch.interop import to_numpy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.scenes.trajectory import dolly_trajectory, orbit_trajectory
from repro_torch.serve.admission import (AdmissionConfig,
                                         AdmissionController,
                                         AdmissionRejected, BucketDemand)
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.cache import (BucketPolicy, ExecutableCache,
                                     validate_buckets)
from repro_torch.serve.placement import build_render_fn, stream_mesh
from repro_torch.serve.scenes import DEFAULT_SCENE_BUCKETS, SceneRegistry
from repro_torch.serve.session import SessionManager, StreamSession


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 8              # B: stream slots (static, if b_buckets unset)
    chunk: int = 4              # F: frames per stream per round
    r_buckets: Tuple[int, ...] = (8, 16, 32)
    # B buckets for the elastic slot batch; None = static B (`slots`).
    b_buckets: Optional[Tuple[int, ...]] = None
    quantile: float = 0.9       # demand quantile for capacity selection
    adapt_every: int = 4        # rounds between R re-evaluation
    history: int = 4096         # demand samples kept for the quantile
    # Split each B's slots over the server's devices (placement.py).
    use_sharding: bool = True
    scene_buckets: Tuple[int, ...] = DEFAULT_SCENE_BUCKETS
    collect_frames: bool = False  # retain rendered frames on sessions
    sim_latency: bool = False   # accelerator-in-the-loop metrics
    sim_keep: int = 4096        # most recent frames kept for the sim
    # Observability (repro_torch/obs): ``trace=True`` records
    # round/plan/resize/admit/build/dispatch/barrier/commit spans (one
    # track per scene-bucket group), per-key first-call spans and each
    # frame's queue wait, exported as Chrome-trace JSON via
    # ``StreamServer.tracer``. Off by default. Whatever it is, a torch
    # profiler that is collecting sees the spans as ``repro.serve/<name>``
    # ranges. The metrics registry is always on (host counters; report()
    # composes it).
    trace: bool = False
    trace_keep: int = Tracer.KEEP  # tracer event-buffer bound
    # Round planning + backpressure + SLO classes (serve/admission.py).
    admission: AdmissionConfig = AdmissionConfig()

    def __post_init__(self):
        validate_buckets(self.r_buckets, "r_buckets")
        if self.b_buckets is not None:
            validate_buckets(self.b_buckets, "b_buckets")
        validate_buckets(self.scene_buckets, "scene_buckets")
        if self.trace_keep < 1:
            raise ValueError(f"trace_keep must be >= 1, got "
                             f"{self.trace_keep}")

    @property
    def slot_buckets(self) -> Tuple[int, ...]:
        """The B values this server may run (static B = one bucket)."""
        return self.b_buckets if self.b_buckets is not None \
            else (self.slots,)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_streams: int = 12         # total arrivals over the run
    rate: float = 2.0           # mean arrivals per round (Poisson)
    min_frames: int = 6
    max_frames: int = 16
    seed: int = 0
    scenes: int = 1             # round-robin arrivals over this many scenes


def sample_trajectory(rng: np.random.Generator,
                      cfg: TrafficConfig) -> np.ndarray:
    """One heterogeneous dolly/orbit trajectory (shared by both traffic
    generators so a replay trace and a Poisson run draw from the same
    pose distribution)."""
    n = int(rng.integers(cfg.min_frames, cfg.max_frames + 1))
    if rng.random() < 0.5:
        dx, dy = rng.uniform(-0.4, 0.4), rng.uniform(-0.4, 0.1)
        return dolly_trajectory(
            n, start=(dx, dy, rng.uniform(-3.0, -1.5)),
            target=(0.0, 0.0, 6.0), device="cpu").numpy()
    return orbit_trajectory(
        n, radius=rng.uniform(5.0, 8.0), target=(0.0, 0.0, 6.0),
        height=rng.uniform(-1.0, 0.0), device="cpu").numpy()


class PoissonTraffic:
    """Poisson arrivals of heterogeneous trajectories over K scenes."""

    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.remaining = int(cfg.n_streams)
        self.arrived = 0

    @property
    def done(self) -> bool:
        return self.remaining <= 0

    def arrivals(self) -> List[Tuple[np.ndarray, int]]:
        """This round's ``(poses, scene_index)`` arrivals; scene_index
        round-robins over ``cfg.scenes`` (the server maps it onto its
        registered scene ids)."""
        if self.done:
            return []
        k = int(min(self.rng.poisson(self.cfg.rate), self.remaining))
        self.remaining -= k
        out = []
        for _ in range(k):
            out.append((sample_trajectory(self.rng, self.cfg),
                        self.arrived % max(self.cfg.scenes, 1)))
            self.arrived += 1
        return out


def skewed_trace(n_streams: int, skew: int = 10,
                 majority_scene: int = 0,
                 minority_scene: int = 1) -> List[List[int]]:
    """Arrival trace with ``skew``:1 per-round bucket skew — each round
    brings ``skew`` majority-scene streams then ONE minority-scene
    stream (the minority arrives last so drain-mode scheduling shows
    its worst case) until ``n_streams`` have arrived. The starvation
    reproducer: under drain-before-switch the minority waits for the
    whole majority backlog; under mixed rounds + aging its max wait is
    bounded by ``max_wait_rounds``."""
    if skew < 1:
        raise ValueError(f"skew must be >= 1, got {skew}")
    trace: List[List[int]] = []
    n = 0
    while n < n_streams:
        rnd = [majority_scene] * min(skew, n_streams - n)
        n += len(rnd)
        if n < n_streams:
            rnd.append(minority_scene)
            n += 1
        trace.append(rnd)
    return trace


def burst_trace(n_streams: int, burst_every: int = 4,
                burst_size: int = 6, scenes: int = 2) -> List[List[int]]:
    """Quiet rounds punctuated by bursts: every ``burst_every`` rounds,
    ``burst_size`` streams arrive at once, round-robined over
    ``scenes`` scene indices — the backpressure/aging stressor (a burst
    overfills the waiting set, then the queue drains over the quiet
    rounds)."""
    if burst_every < 1 or burst_size < 1:
        raise ValueError(f"burst_every and burst_size must be >= 1, got "
                         f"{burst_every}, {burst_size}")
    trace: List[List[int]] = []
    n = 0
    while n < n_streams:
        trace.extend([[]] * (burst_every - 1))
        burst = [i % max(scenes, 1)
                 for i in range(n, min(n + burst_size, n_streams))]
        n += len(burst)
        trace.append(burst)
    return trace


class ReplayTraffic:
    """Deterministic arrival replay: ``trace`` is a list of per-round
    scene-index lists (see ``skewed_trace``/``burst_trace``); each entry
    becomes one arrival with a trajectory sampled from ``cfg``'s pose
    distribution. Same ``arrivals()``/``done`` protocol as
    ``PoissonTraffic`` — ``StreamServer.run`` takes either."""

    def __init__(self, trace: Sequence[Sequence[int]], cfg: TrafficConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._rounds: Deque[List[int]] = deque(list(r) for r in trace)
        self.arrived = 0

    @property
    def done(self) -> bool:
        return not self._rounds

    def arrivals(self) -> List[Tuple[np.ndarray, int]]:
        if self.done:
            return []
        out = [(sample_trajectory(self.rng, self.cfg), int(idx))
               for idx in self._rounds.popleft()]
        self.arrived += len(out)
        return out


class StreamServer:
    """Multi-scene continuous-batching stream server (module docstring).

    Renders on ``device`` (``"cuda"`` by default; pass ``device="cpu"``
    to serve on the CPU). A given ``SceneRegistry`` must hold its scenes
    on that device; the camera is moved there. ``devices`` are those the
    slots may split over (module docstring); the first must be
    ``device``, and a device may repeat.
    """

    TRACE_KEEP = 1024     # most recent per-round dicts kept for report()
    LATENCY_KEEP = 65536  # most recent per-frame latency samples kept
    STACK_KEEP = 8        # memoized per-round scene stacks

    def __init__(self, scene: Union[GaussianScene, SceneRegistry],
                 cam: Camera, base_cfg: RenderConfig,
                 scfg: ServeConfig = ServeConfig(), *, device="cuda",
                 devices: Optional[Sequence] = None):
        self.device = resolve_device(device)

        def indexed(d):
            d = torch.device(d)
            return torch.device("cuda", torch.cuda.current_device()) \
                if d.type == "cuda" and d.index is None else d

        here = indexed(self.device)
        if devices is None:
            devices = [here]
            if here.type == "cuda":
                devices += [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())
                            if i != here.index]
        self.devices = tuple(map(indexed, devices))
        if self.devices[0] != here:
            raise ValueError(f"the first of devices {self.devices} must be "
                             f"the server's device {here}")
        self._meshes: Dict[int, Optional[Tuple[torch.device, ...]]] = {}
        if isinstance(scene, SceneRegistry):
            self.registry = scene
            if not len(self.registry):
                raise ValueError("SceneRegistry has no scenes registered")
            if self.registry.device != self.device:
                raise ValueError(
                    f"the registry holds its scenes on "
                    f"{self.registry.device}, the server renders on "
                    f"{self.device}")
        else:
            self.registry = SceneRegistry(scfg.scene_buckets,
                                          device=self.device)
            self.registry.register(scene)
        self.cam = dataclasses.replace(cam, w2c=cam.w2c.to(self.device))
        self.base_cfg = base_cfg
        self.scfg = scfg
        # ONE metrics registry every serve component publishes into —
        # report() composes its snapshot() — and ONE tracer whose spans
        # the serving round opens below.
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=scfg.trace, keep=scfg.trace_keep,
                             prefix="repro.serve/")
        m = self.metrics
        self._m_streams = m.counter("serve_streams_attached_total",
                                    "streams admitted via attach()")
        self._m_finished = m.counter("serve_streams_finished_total",
                                     "streams drained and detached")
        self._m_rounds = m.counter("serve_rounds_total",
                                   "step() invocations")
        self._m_busy = m.counter("serve_busy_rounds_total",
                                 "rounds that rendered at least one group")
        self._m_frames = m.counter("serve_frames_total",
                                   "real (non-padding) frames rendered")
        self._m_cap_frames = m.counter(
            "serve_capacity_frames_total",
            "sum of B*chunk slot-frames over rendered groups")
        self._m_render_s = m.counter("serve_render_seconds_total",
                                     "wall seconds inside serving rounds")
        self._m_warmup_s = m.counter("serve_warmup_seconds_total",
                                     "wall seconds inside warmup()")
        self._m_concurrent = m.gauge("serve_max_concurrent_streams",
                                     "peak streams bound to slots")
        self._m_trace_drop = m.counter(
            "serve_rounds_trace_dropped_total",
            "per-round trace dicts evicted from the bounded deque")
        # Bounded latency/device-work histograms: lifetime count/sum are
        # exact, percentiles are over the newest LATENCY_KEEP samples —
        # finished StreamSession objects are NOT retained (a churning
        # server would otherwise grow memory without bound). Per-bucket
        # latency histograms feed the fairness split in report().
        self._m_latency = m.histogram(
            "serve_latency_seconds", "per-frame enqueue -> render-complete",
            keep=self.LATENCY_KEEP)
        # A frame's latency is its wait for the round that renders it
        # plus that round's time: t1 - enq = (t0 - enq) + (t1 - t0).
        self._m_wait = m.histogram(
            "serve_queue_wait_seconds",
            "per-frame enqueue -> start of the round that renders it",
            keep=self.LATENCY_KEEP)
        self._m_round_s = m.histogram(
            "serve_round_seconds", "per busy round, start -> barrier",
            keep=self.LATENCY_KEEP)
        self._m_sort_pairs = m.histogram(
            "device_sort_pairs", "pairs entering the per-frame sort",
            keep=scfg.history)
        self._m_culled = m.histogram(
            "device_culled_pairs", "pairs removed by contribution culling",
            keep=scfg.history)
        self._m_demand = m.histogram(
            "device_rerender_demand",
            "re-render tiles wanted per sparse frame (pre-cap)",
            keep=scfg.history)
        self.policy = BucketPolicy(b_buckets=scfg.slot_buckets,
                                   r_buckets=scfg.r_buckets,
                                   quantile=scfg.quantile)
        self.manager = SessionManager(base_cfg.window)
        self.admission = AdmissionController(scfg.admission,
                                             metrics=self.metrics)
        # One batcher per scene bucket in use (the ragged mixed-bucket
        # round's slot groups — a batch can only stack same-bucket
        # scenes, so the bucket IS the group signature). Created eagerly
        # for registered buckets, lazily for buckets registered later.
        self._batchers: Dict[Tuple[int, int], ContinuousBatcher] = {}
        for bucket in self.registry.buckets_in_use():
            self._batcher_for(bucket)
        self.cache = ExecutableCache(tracer=self.tracer)
        self.capacity = int(scfg.r_buckets[0])
        self.capacity_history: List[int] = [self.capacity]
        self.slots_history: List[int] = [scfg.slot_buckets[0]]
        # Bounded per-round trace (the `rounds_trace` report block):
        # newest TRACE_KEEP round dicts; evictions are counted and
        # published as rounds_trace_dropped so a long-lived server's
        # report says how much history the bound cost it.
        self.trace: Deque[dict] = deque(maxlen=self.TRACE_KEEP)
        # Rolling per-sparse-frame demand samples (flat ints — all the
        # capacity picker needs), newest last.
        self._demand: Deque[int] = deque(maxlen=scfg.history)
        # Accelerator-in-the-loop trace: per-group device-side records
        # in service order (host conversion is deferred to report() so
        # the serving rounds never pay record transfers), bounded like
        # the latency reservoir.
        self._sim_rounds: Deque[tuple] = deque(
            maxlen=max(1, scfg.sim_keep // max(scfg.chunk, 1)))
        self._sim_dropped = 0
        self._stacks: Dict[tuple, object] = {}

    # -- metrics-backed counters -------------------------------------------
    # The registry is the single source of truth (report() composes its
    # snapshot); these properties keep the original attribute API for
    # callers and tests.
    @property
    def streams_seen(self) -> int:
        return int(self._m_streams.value)

    @property
    def streams_finished(self) -> int:
        return int(self._m_finished.value)

    @property
    def rounds(self) -> int:
        return int(self._m_rounds.value)

    @property
    def busy_rounds(self) -> int:
        return int(self._m_busy.value)

    @property
    def active_slot_frames(self) -> int:
        return int(self._m_frames.value)

    @property
    def capacity_frames(self) -> int:
        return int(self._m_cap_frames.value)

    @property
    def render_seconds(self) -> float:
        return float(self._m_render_s.value)

    @property
    def warmup_seconds(self) -> float:
        return float(self._m_warmup_s.value)

    @property
    def max_concurrent(self) -> int:
        return int(self._m_concurrent.value)

    def _sync(self) -> None:
        """Wait for the server's device and every device a slot split
        holds (the round barrier)."""
        devs = {self.device}
        for mesh in self._meshes.values():
            devs.update(mesh or ())
        for dev in devs:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- scenes ------------------------------------------------------------
    @property
    def default_scene_id(self) -> int:
        return self.registry.ids()[0]

    def register_scene(self, scene: GaussianScene):
        """Admit a new scene mid-serving; invalidates memoized stacks."""
        entry = self.registry.register(scene, now=self.clock())
        self._stacks.clear()
        return entry

    def evict_scene(self, scene_id: int):
        """Evict a drained scene (raises while streams are attached).

        If the scene's bucket leaves ``registry.buckets_in_use()``, the
        bucket's batcher (device-resident idle carries) and every cached
        executable keyed on that bucket are dropped too — a long-running
        server that churns scenes across buckets must not grow device
        memory without bound (``cache.stats()["evicted_keys"]`` counts
        the drops)."""
        entry = self.registry.evict(scene_id)
        self._stacks.clear()
        if entry.bucket not in self.registry.buckets_in_use():
            self._batchers.pop(entry.bucket, None)
            self.cache.evict_keys(lambda k: k[0] == entry.bucket)
        return entry

    def scene_for_index(self, idx: int) -> int:
        """Traffic scene index -> registered scene id (round-robin)."""
        ids = self.registry.ids()
        return ids[idx % len(ids)]

    # -- lifecycle ---------------------------------------------------------
    def clock(self) -> float:
        return time.perf_counter()

    def attach(self, poses, now: Optional[float] = None,
               scene_id: Optional[int] = None,
               slo: Optional[str] = None) -> StreamSession:
        """Attach a stream, or raise ``AdmissionRejected`` when the
        waiting set is full (``AdmissionConfig.max_waiting`` — the
        backpressure contract; use ``try_attach`` for a non-raising
        probe). ``slo`` names a service class from
        ``AdmissionConfig.slo_classes``."""
        sid = self.default_scene_id if scene_id is None else scene_id
        self.registry.get(sid)         # raises on unknown scene
        self.scfg.admission.slo(slo)   # raises on unknown SLO class
        if not self.admission.offer(len(self.manager.waiting())):
            raise AdmissionRejected(
                f"waiting set is full "
                f"({self.scfg.admission.max_waiting}); retry later")
        sess = self.manager.attach(
            poses, now=self.clock() if now is None else now, scene_id=sid,
            slo=slo)
        self.registry.acquire(sid)     # pin only once the attach stuck
        self._m_streams.inc()
        return sess

    def try_attach(self, poses, now: Optional[float] = None,
                   scene_id: Optional[int] = None,
                   slo: Optional[str] = None) -> Optional[StreamSession]:
        """``attach`` that returns None instead of raising on
        backpressure (the defer signal for callers that retry)."""
        try:
            return self.attach(poses, now=now, scene_id=scene_id, slo=slo)
        except AdmissionRejected:
            return None

    def detach(self, sid: int) -> StreamSession:
        """Cancel a stream mid-flight: remove its session AND release its
        scene pin. Server-attached streams must be cancelled here, not
        via ``manager.detach`` directly — the manager knows nothing of
        the registry, so a direct detach would leave ``entry.refs``
        pinned forever and block ``evict_scene``. (The batcher reclaims
        the cancelled stream's slot on the next round.)"""
        sess = self.manager.detach(sid)
        self.registry.release(sess.scene_id)
        return sess

    # -- executable selection ----------------------------------------------
    def _key_for(self, bucket, b: int, r: int):
        # scene_bucket is the (padded N, sh K) shape signature; impl is
        # the raster kernel path (DESIGN.md §9) — both change the
        # lowering, and a server serving many scenes or reconfigured
        # across backends must never reuse a stale executable.
        return (bucket, int(b), self.scfg.chunk, int(r),
                self.base_cfg.window, self.base_cfg.impl)

    def _mesh_for(self, b: int):
        if not self.scfg.use_sharding:
            return None
        if b not in self._meshes:
            self._meshes[b] = stream_mesh(b, self.devices)
        return self._meshes[b]

    def _group_for(self, b: int) -> int:
        mesh = self._mesh_for(b)
        return b // len(mesh) if mesh is not None else b

    def _build_for(self, b: int, r: int):
        cfg = dataclasses.replace(self.base_cfg, rerender_capacity=int(r))
        return build_render_fn(self.cam, cfg, self._mesh_for(b),
                               multi_scene=True)

    def _executable(self, bucket, b: int):
        r = self.capacity
        return self.cache.get(self._key_for(bucket, b, r),
                              lambda: self._build_for(b, r))

    def _batcher_for(self, bucket) -> ContinuousBatcher:
        bat = self._batchers.get(bucket)
        if bat is None:
            b0 = self.scfg.slot_buckets[0]
            # With the contribution prior threaded (contrib_enabled),
            # carries hold an (N,) leaf — N is the bucket's padded
            # Gaussian count, so every scene in the bucket shares one
            # carry structure.
            n = bucket[0] if contrib_enabled(self.base_cfg) \
                else None
            bat = ContinuousBatcher(
                b0, self.scfg.chunk, self.cam, group=self._group_for(b0),
                collect_frames=self.scfg.collect_frames, bucket=bucket,
                n_gaussians=n, tracer=self.tracer)
            self._batchers[bucket] = bat
        return bat

    @property
    def batcher(self) -> ContinuousBatcher:
        """The sole in-use batcher — single-bucket convenience (tests,
        the degenerate single-scene server). Ambiguous with multiple
        buckets in flight: use ``batcher_for`` then."""
        if len(self._batchers) == 1:
            return next(iter(self._batchers.values()))
        raise ValueError(
            f"{len(self._batchers)} bucket batchers in use "
            f"({list(self._batchers)}); use batcher_for(bucket)")

    def batcher_for(self, bucket) -> ContinuousBatcher:
        """The slot-group batcher serving ``bucket`` (created on first
        use)."""
        return self._batcher_for(bucket)

    @property
    def total_bound(self) -> int:
        """Streams bound to a slot across every bucket group."""
        return sum(bat.bound for bat in self._batchers.values())

    def _stack_for(self, scene_ids: Tuple[Optional[int], ...],
                   bucket, size: int):
        """Round's ``size`` scenes (``registry.stack``), memoized while
        the bound scene set is stable across rounds."""
        ids = tuple(self.default_scene_id if i is None else i
                    for i in scene_ids)
        if not ids:
            ids = (self.registry.by_bucket(bucket)[0],)
        key = (ids, int(size))
        if key not in self._stacks:
            if len(self._stacks) >= self.STACK_KEEP:
                self._stacks.pop(next(iter(self._stacks)))
            self._stacks[key] = self.registry.stack(ids, size)
        return self._stacks[key]

    def warmup(self) -> float:
        """Build every (scene_bucket, B, R) cache entry before traffic.

        Runs each combination once on an all-masked (count-0) batch.
        In the port a masked frame is not rendered, so this creates the
        entries and their first-call records but moves no first-use cost
        (kernel library loads) out of the first busy round. Returns
        wall seconds spent THIS call; ``warmup_seconds`` accumulates.
        Safe mid-serving: the batch is synthesized (``empty_batch``),
        and its scene tuples bypass the bounded ``_stacks`` memo.
        """
        t0 = self.clock()
        with self.tracer.span("warmup", track="round"):
            for bucket in self.registry.buckets_in_use():
                ids = (self.registry.by_bucket(bucket)[0],)
                bat = self._batcher_for(bucket)
                for b in self.policy.b_buckets:
                    batch = bat.empty_batch(slots=b)
                    # Transient stack: NOT memoized (see docstring).
                    scenes = self.registry.stack(ids, b)
                    for r in self.policy.r_buckets:
                        fn = self.cache.get(
                            self._key_for(bucket, b, r),
                            lambda b=b, r=r: self._build_for(b, r))
                        fn(scenes, batch.poses, batch.counts, batch.phases,
                           batch.carries, batch.slot_scene)
            self._sync()
        spent = self.clock() - t0
        self._m_warmup_s.inc(spent)
        return spent

    # -- adaptive shapes ---------------------------------------------------
    def _bucket_of(self, sess: StreamSession) -> Tuple[int, int]:
        sid = self.default_scene_id if sess.scene_id is None \
            else sess.scene_id
        return self.registry.bucket_of(sid)

    def _bucket_demand(self) -> Dict[Tuple[int, int], BucketDemand]:
        """Per-bucket demand snapshot for the admission controller:
        streams wanting service (bound, or waiting with pending poses),
        their SLO weights, and the oldest-stream order tiebreak."""
        demand: Dict[Tuple[int, int], BucketDemand] = {}
        for s in self.manager.sessions.values():
            if s.slot is None and not s.pending:
                continue
            b = self._bucket_of(s)
            d = demand.setdefault(b, BucketDemand())
            cls = self.scfg.admission.slo(s.slo)
            d.depth += 1
            # weight >= 1 inflates effective depth (snaps B up sooner);
            # < 1 never shrinks it below the true queue.
            d.weighted_depth += max(1.0, cls.weight)
            d.weight = max(d.weight, cls.weight)
            d.order = min(d.order, s.sid)
            if s.slot is not None:
                d.bound += 1
            if s.pending:
                d.pending += 1
            if cls.max_wait_rounds is not None:
                d.wait_bound = cls.max_wait_rounds if d.wait_bound is None \
                    else min(d.wait_bound, cls.max_wait_rounds)
        return demand

    def _maybe_resize(self, bucket, d: BucketDemand) -> None:
        """Snap this bucket's B to the bucket covering its SLO-weighted
        queue depth (elastic B). The batcher resize unbinds overflow
        sessions on shrink — carries stay on the sessions, so the
        resize drops nothing."""
        if self.scfg.b_buckets is None:
            return
        bat = self._batcher_for(bucket)
        b = self.policy.pick_slots(int(math.ceil(d.weighted_depth)))
        if b != bat.slots:
            bat.resize(b, self.manager, group=self._group_for(b))
            self.slots_history.append(b)

    def _observe(self, result) -> int:
        """Fold a group's records into the demand history; re-pick R.
        Returns the group's real key frames.

        Only real (non-padding) sparse frames contribute demand samples
        — ``plan.rerender_demand`` per frame, the same statistic
        ``cache.suggest_capacity`` computes from raw records. The adapt
        cadence counts BUSY rounds (this method only runs on those), so
        traffic gaps never starve adaptation.
        """
        recs = result.records
        mask = to_numpy(result.frame_active).reshape(-1)
        full = to_numpy(recs.is_full).reshape(-1)
        sparse = mask & ~full
        # Device-work histograms: per-frame sort pairs and culled pairs
        # over real frames, re-render demand over real sparse frames —
        # derived from the records the engine already returns.
        t = to_numpy(recs.sort_pairs)
        self._m_sort_pairs.observe_many(
            t.reshape(-1, t.shape[-1]).sum(axis=-1)[mask])
        self._m_culled.observe_many(
            to_numpy(recs.culled_pairs).reshape(-1)[mask])
        if sparse.any():
            demand = to_numpy(rerender_demand(
                recs.active, recs.overflow_tiles)).reshape(-1)
            self._demand.extend(demand[sparse].tolist())
            self._m_demand.observe_many(demand[sparse])
        if self._demand and self.busy_rounds % self.scfg.adapt_every == 0:
            new_cap = self.policy.pick_capacity(list(self._demand))
            if new_cap != self.capacity:
                self.capacity = new_cap
                self.capacity_history.append(new_cap)
        return int((mask & full).sum())

    # -- accelerator-in-the-loop -------------------------------------------
    def _record_sim(self, batch, result) -> None:
        """Stash a group's stacked records (device references — one
        deque append, no host transfer on the serving path; the
        FrameWork conversion is deferred to ``_sim_report``)."""
        counts = to_numpy(batch.counts)
        active = tuple(s is not None and counts[i] > 0
                       for i, s in enumerate(batch.sids))
        if self._sim_rounds.maxlen and \
                len(self._sim_rounds) == self._sim_rounds.maxlen:
            _, old_counts, old_active = self._sim_rounds[0]
            self._sim_dropped += int(sum(
                c for c, a in zip(old_counts, old_active) if a))
        self._sim_rounds.append((result.records.stacked, counts, active))

    def _sim_frameworks(self) -> Tuple[List[FrameWork], int]:
        """Host-convert the stashed groups into per-frame FrameWorks,
        service order (round-major, slot order within a group). Returns
        ``(frames, tail_trimmed)`` — the deque bounds round memory, the
        ``sim_keep`` trim bounds the sim itself, and the trim count
        must reach the drop accounting (report-time, no mutation: the
        deque-evicted drops live in ``_sim_dropped``; summing both at
        report keeps ``report()`` idempotent)."""
        frames: List[FrameWork] = []
        n_px = self.cam.height * self.cam.width
        for stacked, counts, active in self._sim_rounds:
            for i, on in enumerate(active):
                if not on:
                    continue
                recs = FrameRecord(*(None if a is None else a[i]
                                     for a in stacked))
                frames.extend(frameworks_from_stacked(
                    StackedRecords(recs), self.cam.tiles_x,
                    self.cam.tiles_y, n_px)[:counts[i]])
        trimmed = max(0, len(frames) - self.scfg.sim_keep)
        return frames[-self.scfg.sim_keep:], trimmed

    def _sim_report(self) -> Optional[dict]:
        """Replay the served frames through the accelerator model —
        simulated ASIC cycles for the exact schedules the engine
        recorded (policy="recorded", streaming pipeline on)."""
        frames, trimmed = self._sim_frameworks()
        if not frames:
            return None
        acfg = AcceleratorConfig(num_blocks=self.base_cfg.ldu_blocks)
        timings = simulate_sequence(frames, acfg, policy="recorded",
                                    streaming=True)
        agg = throughput(timings, acfg.num_blocks)
        # Per-frame service latency in the streaming pipeline: the gap
        # this frame adds to the completion front (frame_end is
        # monotone; overlapped frames add less than their span).
        ends = np.asarray([t.frame_end for t in timings])
        service = np.diff(ends, prepend=0.0)
        return {
            "frames": len(frames),
            # BOTH drop paths: rounds evicted from the bounded deque
            # (_sim_dropped) AND the report-time tail trim to sim_keep.
            "frames_dropped": self._sim_dropped + trimmed,
            "cycles_per_frame": round(float(agg["cycles_per_frame"]), 1),
            "utilization": round(float(agg["utilization"]), 4),
            "sort_stall_cycles": round(float(agg["sort_stall"]), 1),
            "latency_p50_cycles": round(float(np.percentile(service, 50)),
                                        1),
            "latency_p99_cycles": round(float(np.percentile(service, 99)),
                                        1),
        }

    # -- the serving round -------------------------------------------------
    def _bucket_latency(self, bucket) -> "object":
        """The per-scene-bucket latency histogram (labeled family of
        ``serve_latency_seconds``) — get-or-create, so report() can read
        a bucket that never rendered and see None percentiles."""
        return self.metrics.histogram(
            "serve_latency_seconds",
            "per-frame enqueue -> render-complete",
            keep=self.LATENCY_KEEP, bucket=str(bucket))

    def _push_round(self, info: dict) -> None:
        """Append to the bounded rounds_trace, counting the eviction the
        bound forces (report() publishes rounds_trace_dropped)."""
        if len(self.trace) == self.trace.maxlen:
            self._m_trace_drop.inc()
        self.trace.append(info)

    def _trace_waits(self, batch, t0: float, rnd: int) -> None:
        """Each of the group's frames' queue wait as an async span, id
        ``<session>.<frame>``, before ``commit`` counts the frames."""
        for i, sid in enumerate(batch.sids):
            sess = self.manager.sessions.get(sid) if sid is not None \
                else None
            if sess is None:
                continue
            for k, t in enumerate(batch.enq_times[i]):
                self.tracer.async_span(
                    "queue_wait", t, t0, f"{sid}.{sess.frames_rendered + k}",
                    track="queue", args={"round": rnd})

    def step(self) -> dict:
        self._m_rounds.inc()
        rnd = self.rounds
        tr = self.tracer
        # The round span copies its args when it closes: the frame counts
        # are added below.
        round_args = {"round": rnd}
        with tr.span("round", track="round", args=round_args):
            with tr.span("plan", track="round"):
                demand = self._bucket_demand()
                plan = self.admission.plan_round(demand)
            t0 = self.clock()
            # Render every planned bucket group in turn; the barrier below
            # closes the round. Each group's host phases get spans on the
            # group's own track ("bucket <sig>").
            groups = []
            for bucket in plan:
                tk = f"bucket {bucket}"
                bat = self._batcher_for(bucket)
                with tr.span("resize", track=tk):
                    self._maybe_resize(bucket, demand[bucket])
                with tr.span("admit", track=tk):
                    bat.admit(self.manager,
                              allowed=set(self.registry.by_bucket(bucket)))
                with tr.span("build", track=tk):
                    batch = bat.build(self.manager)
                if batch.active_frames == 0:
                    continue
                key = self._key_for(bucket, bat.slots, self.capacity)
                with tr.span("dispatch", track=tk,
                             args={"key": str(key),
                                   "frames": batch.active_frames}):
                    scenes = self._stack_for(batch.scene_ids, bucket,
                                             bat.slots)
                    fn = self._executable(bucket, bat.slots)
                    result = fn(scenes, batch.poses, batch.counts,
                                batch.phases, batch.carries,
                                batch.slot_scene)
                groups.append((bucket, bat, batch, result))
            self._m_concurrent.set_max(self.total_bound)
            served = [bucket for bucket, *_ in groups]
            self.admission.note_round(demand, served)
            if not groups:
                info = {"round": rnd, "frames": 0, "bound_slots": 0,
                        "groups": [], "capacity": self.capacity}
                self._push_round(info)
                return info
            with tr.span("barrier", track="round",
                         args={"groups": len(groups)}):
                self._sync()
            t1 = self.clock()
            self._m_busy.inc()         # before _observe: its adapt cadence
            self._m_round_s.observe(t1 - t0)
            total_frames = key_frames = 0
            group_infos = []
            scene_ids_served: List[int] = []
            for bucket, bat, batch, result in groups:
                with tr.span("commit", track=f"bucket {bucket}"):
                    if tr.enabled:
                        self._trace_waits(batch, t0, rnd)
                    detached = bat.commit(batch, result, self.manager, t1)
                    for sess in detached:
                        self.registry.release(sess.scene_id)
                    self._m_finished.inc(len(detached))
                    counts = batch.counts.tolist()
                    blat = self._bucket_latency(bucket)
                    for i in range(len(batch.sids)):
                        enq = batch.enq_times[i][:counts[i]]
                        lats = [t1 - t for t in enq]
                        self._m_latency.observe_many(lats)
                        blat.observe_many(lats)
                        self._m_wait.observe_many([t0 - t for t in enq])
                    key_frames += self._observe(result)  # busy rounds
                    if self.scfg.sim_latency:
                        self._record_sim(batch, result)
                    self.admission.record_service(bucket,
                                                  batch.active_frames)
                    self._m_frames.inc(batch.active_frames)
                    self._m_cap_frames.inc(bat.slots * self.scfg.chunk)
                    total_frames += batch.active_frames
                    ids = [i for i in batch.scene_ids if i is not None]
                    scene_ids_served.extend(ids)
                    group_infos.append({
                        "scene_bucket": bucket,
                        "frames": batch.active_frames,
                        "bound_slots": batch.bound_slots,
                        "slots": bat.slots,
                        "scene_ids": ids, "detached": len(detached)})
            self._m_render_s.inc(t1 - t0)
            round_args.update(frames=total_frames, key_frames=key_frames)
        info = {"round": rnd, "frames": total_frames,
                "bound_slots": sum(g["bound_slots"] for g in group_infos),
                "groups": group_infos,
                "scene_ids": scene_ids_served,
                "capacity": self.capacity,
                "render_seconds": round(t1 - t0, 4),
                "detached": sum(g["detached"] for g in group_infos)}
        if len(group_infos) == 1:
            # Single-group rounds keep the legacy flat fields.
            info["scene_bucket"] = group_infos[0]["scene_bucket"]
            info["slots"] = group_infos[0]["slots"]
        self._push_round(info)
        return info

    def run(self, traffic=None, max_rounds: int = 1000) -> dict:
        """Serve until traffic is drained (or ``max_rounds``); report.

        ``traffic`` is anything with the ``arrivals()``/``done``
        protocol (``PoissonTraffic``, ``ReplayTraffic``). Arrivals the
        admission controller defers (backpressure) are retried next
        round, not dropped."""
        deferred: List[Tuple[np.ndarray, int]] = []
        while self.rounds < max_rounds:
            if traffic is not None:
                offered = deferred + traffic.arrivals()
                deferred = []
                for poses, scene_idx in offered:
                    sess = self.try_attach(
                        poses, scene_id=self.scene_for_index(scene_idx))
                    if sess is None:
                        deferred.append((poses, scene_idx))
            if (traffic is None or traffic.done) and not deferred \
                    and not self.manager.sessions:
                break
            self.step()
        return self.report()

    # -- metrics -----------------------------------------------------------
    @staticmethod
    def _pct_ms(lat: np.ndarray, q: float) -> Optional[float]:
        return round(1e3 * float(np.percentile(lat, q)), 3) \
            if lat.size else None

    def _per_bucket_report(self) -> dict:
        """Per-scene-bucket fairness split: latency percentiles over the
        bucket's own reservoir (the labeled ``serve_latency_seconds``
        histogram family) next to the admission controller's wait/share
        accounting. Buckets that never rendered a frame report None
        percentiles — never NaN, never raise."""
        adm = self.admission
        shares = adm.shares()
        buckets = (set(adm.demand_rounds) | set(adm.frames_served)
                   | set(self._batchers))
        out = {}
        for b in sorted(buckets):
            lat = np.asarray(self._bucket_latency(b).values())
            bat = self._batchers.get(b)
            out[str(b)] = {
                "frames": adm.frames_served.get(b, 0),
                "latency_p50_ms": self._pct_ms(lat, 50),
                "latency_p99_ms": self._pct_ms(lat, 99),
                "max_wait_rounds": adm.max_wait.get(b, 0),
                "demand_rounds": adm.demand_rounds.get(b, 0),
                "served_rounds": adm.served_rounds.get(b, 0),
                "share": round(shares.get(b, 1.0), 4),
                "slots": bat.slots if bat is not None else None,
            }
        return out

    def _publish_residency(self) -> None:
        """Refresh the scene-residency gauges from the registry (gauges
        are last-written, so report() re-publishing keeps them honest
        after register/evict churn)."""
        for b, r in self.registry.residency().items():
            for field in ("scenes", "padded_bytes", "refs"):
                self.metrics.gauge(
                    f"scene_residency_{field}",
                    f"per-bucket resident-scene {field}",
                    bucket=str(b)).set(r[field])

    def report(self) -> dict:
        lat = np.asarray(self._m_latency.values())
        frames = int(self.active_slot_frames)
        meshes = [m for m in self._meshes.values() if m is not None]
        self._publish_residency()
        adm = self.admission.report()
        fairness = {k: adm[k] for k in
                    ("mode", "jain_service", "max_wait_rounds",
                     "max_wait_rounds_config", "deferred")}
        return {
            "streams_served": self.streams_seen,
            "streams_finished": self.streams_finished,
            "max_concurrent": self.max_concurrent,
            "frames": frames,
            "rounds": self.rounds,
            "busy_rounds": self.busy_rounds,
            "latency_p50_ms": self._pct_ms(lat, 50),
            "latency_p99_ms": self._pct_ms(lat, 99),
            "frames_per_second": round(frames / self.render_seconds, 2)
            if self.render_seconds > 0 else None,
            "slot_utilization": round(frames / self.capacity_frames, 4)
            if self.capacity_frames else 0.0,
            "capacity": self.capacity,
            "capacity_history": list(self.capacity_history),
            "slots": max((bat.slots for bat in self._batchers.values()),
                         default=self.scfg.slot_buckets[0]),
            "slots_history": list(self.slots_history),
            "scenes": self.registry.stats(),
            "fairness": fairness,
            "per_bucket": self._per_bucket_report(),
            "sim": self._sim_report(),
            "warmup_seconds": round(self.warmup_seconds, 3),
            # One composed snapshot of the shared registry (counters,
            # gauges, histograms) — the obs contract's single source of
            # truth; everything above is a view over the same numbers.
            "metrics": self.metrics.snapshot(),
            "rounds_trace": list(self.trace),
            "rounds_trace_dropped": int(self._m_trace_drop.value),
            "cache_log": [{"event": ev, "key": list(map(str, key))}
                          for ev, key in self.cache.log],
            "num_devices": max((len(m) for m in meshes), default=1),
            "cache": self.cache.stats(),
        }
