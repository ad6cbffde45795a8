"""Bucketed render-function cache + the 2-axis ``(B, R)`` bucket policy
(port of ``repro/serve/cache.py``).

Every distinct ``(scene_bucket, B, chunk, R, window, impl)`` tuple is one
cache entry, so the shapes that adapt while serving stay bounded:

- **R** (``r_buckets``): ``snap_capacity`` rounds a demand estimate up to
  the smallest bucket covering it (the largest caps runaway demand; the
  overflow degrades to interpolation). ``suggest_capacity`` picks the
  bucket from the ``quantile`` of recorded per-sparse-frame re-render
  demand (``plan.rerender_demand``).
- **B** (``b_buckets``): the slot-batch size snaps the same way, driven
  by queue depth.
- **scene N** is bucketed at registration (``serve/scenes.py``).

``ExecutableCache`` holds one entry per key, built lazily, with hit/miss
counters. In the port an entry is the render callable from
``placement.build_render_fn``; nothing is compiled per key, so an
entry's first-call time ("compile_ms") is first-use cost — the CUDA
library loads on the first call of a process, and little after that.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (Callable, Deque, Dict, Hashable, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.plan import rerender_demand
from repro_torch.interop import to_numpy
from repro_torch.obs.trace import PROCESS_TRACER, Tracer

DEFAULT_R_BUCKETS = (8, 16, 32)
DEFAULT_B_BUCKETS = (2, 4, 8)


def validate_buckets(buckets: Sequence[int],
                     name: str = "r_buckets") -> None:
    """Bucket lists must be ascending and unique (snap_capacity scans in
    order, so a shuffled list would snap to the wrong executable).
    ``name`` is the argument being validated — the error must blame the
    actual offender (b_buckets/scene_buckets validate here too)."""
    if not len(buckets) or list(buckets) != \
            sorted(set(int(r) for r in buckets)):
        raise ValueError(
            f"{name} must be ascending and unique, got {buckets}")


def snap_capacity(demand: float, buckets: Sequence[int]) -> int:
    """Smallest bucket covering ``demand``; the largest bucket if none do."""
    for r in buckets:
        if demand <= r:
            return int(r)
    return int(buckets[-1])


def pick_capacity(sparse_demands, quantile: float,
                  buckets: Sequence[int]) -> int:
    """The bucket covering the ``quantile`` of per-sparse-frame demands
    (smallest bucket when nothing has been observed yet)."""
    demands = np.asarray(sparse_demands).reshape(-1)
    if demands.size == 0:
        return int(buckets[0])
    return snap_capacity(float(np.quantile(demands, quantile)), buckets)


def suggest_capacity(records, quantile: float = 0.9,
                     buckets: Sequence[int] = DEFAULT_R_BUCKETS,
                     frame_mask=None) -> int:
    """Pick ``rerender_capacity`` from recorded overflow stats.

    ``records`` is anything exposing stacked ``FrameRecord`` fields
    (``StackedRecords``, ``(F, ...)`` or ``(B, F, ...)``). Demand is
    measured on sparse frames only (full frames always re-render every
    tile); ``frame_mask`` (e.g. ``StreamsResult.frame_active``) further
    restricts to real — non-padding — frames. With no sparse frames
    observed yet, returns the smallest bucket.
    """
    demand = to_numpy(rerender_demand(
        records.active, records.overflow_tiles)).reshape(-1)
    sparse = ~np.asarray(to_numpy(records.is_full)).reshape(-1)
    if frame_mask is not None:
        sparse &= np.asarray(to_numpy(frame_mask)).reshape(-1)
    return pick_capacity(demand[sparse], quantile, buckets)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The 2-axis serving shape policy: pick ``(B, R)`` from buckets.

    Frozen and validated at construction so a server can hold one policy
    for its lifetime; ``max_keys`` is the hard bound on distinct
    executables the policy can ever request (per scene bucket).
    """

    b_buckets: Tuple[int, ...] = DEFAULT_B_BUCKETS
    r_buckets: Tuple[int, ...] = DEFAULT_R_BUCKETS
    quantile: float = 0.9

    def __post_init__(self):
        validate_buckets(self.b_buckets, "b_buckets")
        validate_buckets(self.r_buckets, "r_buckets")
        if not 0.0 <= self.quantile <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got "
                             f"{self.quantile}")

    @property
    def max_keys(self) -> int:
        return len(self.b_buckets) * len(self.r_buckets)

    def pick_slots(self, queue_depth: int) -> int:
        """B bucket covering the streams that currently want service
        (the largest bucket caps a flood — excess streams wait)."""
        return snap_capacity(max(int(queue_depth), 1), self.b_buckets)

    def pick_capacity(self, sparse_demands) -> int:
        """R bucket covering the demand quantile (see pick_capacity)."""
        return pick_capacity(sparse_demands, self.quantile, self.r_buckets)

    def pick(self, queue_depth: int, sparse_demands) -> Tuple[int, int]:
        return self.pick_slots(queue_depth), self.pick_capacity(
            sparse_demands)


def suggest_buckets(records, queue_depth: int,
                    policy: BucketPolicy = BucketPolicy(),
                    frame_mask=None) -> Tuple[int, int]:
    """``suggest_capacity`` grown to 2 axes: ``(B, R)`` from the current
    queue depth plus recorded per-sparse-frame re-render demand."""
    r = suggest_capacity(records, policy.quantile, policy.r_buckets,
                         frame_mask)
    return policy.pick_slots(queue_depth), r


@dataclasses.dataclass
class CacheEntry:
    fn: Callable                  # instrumented dispatch wrapper
    hits: int = 0
    # First-call vs later-call split: the first call through an entry is
    # where first-use costs land — its wall time is recorded here,
    # separately from the accumulators that every later call feeds. All
    # host-timed; the port's render callables return after their last
    # frame's host sync.
    compile_seconds: Optional[float] = None
    dispatch_calls: int = 0
    dispatch_seconds: float = 0.0


class ExecutableCache:
    """Lazily-built callables keyed by bucket tuple, with hit/miss stats.

    ``log`` keeps the most recent lookups only (the counters are exact
    for the whole lifetime) so a long-running server's memory stays flat.

    Every entry's callable is wrapped to split its first call's time
    ("compile", the first-use cost) from later calls' time per key
    (``stats()`` surfaces both as ``per_key_timing``); with a
    ``tracer``, the first call emits a ``compile`` span carrying the key,
    so the trace shows which round paid it.
    """

    LOG_KEEP = 1024

    def __init__(self, tracer: Optional[Tracer] = None):
        self._entries: Dict[Hashable, CacheEntry] = {}
        self._tracer = PROCESS_TRACER if tracer is None else tracer
        self.misses = 0
        self.hits = 0
        self.evicted_keys = 0
        self.log: Deque[Tuple[str, Hashable]] = deque(maxlen=self.LOG_KEEP)

    def _instrument(self, key: Hashable, fn: Callable,
                    entry: CacheEntry) -> Callable:
        def dispatch(*args, **kwargs):
            if entry.compile_seconds is None:
                # First call: its wall time holds the entry's first-use
                # costs.
                with self._tracer.span("compile", track="cache",
                                       args={"key": str(key)}):
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    entry.compile_seconds = time.perf_counter() - t0
                return out
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            entry.dispatch_seconds += time.perf_counter() - t0
            entry.dispatch_calls += 1
            return out
        return dispatch

    def get(self, key: Hashable,
            builder: Optional[Callable[[], Callable]] = None) -> Callable:
        entry = self._entries.get(key)
        if entry is None:
            if builder is None:
                raise KeyError(key)
            self.misses += 1
            self.log.append(("miss", key))
            entry = CacheEntry(fn=None)
            entry.fn = self._instrument(key, builder(), entry)
            self._entries[key] = entry
        else:
            self.hits += 1
            entry.hits += 1
            self.log.append(("hit", key))
        return entry.fn

    def evict_keys(self, match: Callable[[Hashable], bool]) -> int:
        """Drop every entry whose key matches — the server calls this
        when a scene bucket leaves ``registry.buckets_in_use()``, so a
        scene-churning server's executable (and device-constant) memory
        stays bounded by the buckets actually in use. Returns the count
        dropped (also accumulated in ``evicted_keys``/``stats()``)."""
        doomed = [k for k in self._entries if match(k)]
        for k in doomed:
            del self._entries[k]
            self.log.append(("evict", k))
        self.evicted_keys += len(doomed)
        return len(doomed)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key_str(k: Hashable):
        return list(map(str, k)) if isinstance(k, tuple) else str(k)

    def stats(self) -> dict:
        return {
            "distinct_executables": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evicted_keys": self.evicted_keys,
            "keys": [self._key_str(k) for k in self._entries],
            # Per-key hit counts: which (bucket, B, R) groups actually
            # carry the traffic (the mixed-round fairness work reads
            # this next to the per-bucket latency split).
            "per_key_hits": {str(k): e.hits
                             for k, e in self._entries.items()},
            # First-call wall time (first-use costs) next to the later
            # calls' accumulators, per key. compile_ms is None until the
            # entry's first call (built but never invoked).
            "per_key_timing": {str(k): {
                "compile_ms": None if e.compile_seconds is None
                else round(1e3 * e.compile_seconds, 3),
                "dispatch_calls": e.dispatch_calls,
                "dispatch_ms_total": round(1e3 * e.dispatch_seconds, 3),
                "dispatch_ms_mean": round(
                    1e3 * e.dispatch_seconds / e.dispatch_calls, 3)
                if e.dispatch_calls else None,
            } for k, e in self._entries.items()},
        }
