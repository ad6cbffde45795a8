"""Admission control for the multi-bucket serve loop: who renders when
(port of ``repro/serve/admission.py``, host logic only).

The server's ragged mixed-bucket rounds (server.py, DESIGN.md §11) can
dispatch one executable per scene-bucket group in a single round — but
*which* groups run, and in what order, is a policy question, and the
naive answer ("drain the in-flight bucket first") is exactly the
fleet-level stall the paper warns about: a minority-bucket stream stuck
behind a busy majority bucket waits unboundedly. This module owns that
policy:

- **Round planning** (``plan_round``): given per-bucket demand, return
  the ordered list of scene buckets this round serves. ``mode="mixed"``
  (default) serves every bucket with pending work, ordered by SLO
  weight x rounds waited; ``max_groups_per_round`` caps the list (a
  device-budget knob), and **aging** guarantees the cap never starves:
  a bucket that would exceed its ``max_wait_rounds`` if skipped again
  jumps the queue. ``mode="drain"`` reproduces the legacy
  drain-before-switch loop — kept so benchmarks/serve_bench.py can
  demonstrate the starvation it causes (the before/after replay).
- **Backpressure** (``offer``): with ``max_waiting`` set, the waiting
  set is bounded — ``offer`` returns False when full and the caller
  must defer or reject the stream (``StreamServer.attach`` raises
  ``AdmissionRejected``; ``try_attach``/``run`` defer and retry).
- **SLO classes** (``SLOClass``): per-stream service classes. ``weight``
  biases both the elastic-B resize (a heavy class inflates its bucket's
  effective queue depth, snapping B up sooner) and group ordering;
  ``max_wait_rounds`` tightens the aging bound for buckets with that
  class waiting (an interactive bucket ages out of the queue faster
  than bulk).
- **Fairness accounting** (``report``): per-bucket demand/served round
  counts, lifetime max wait, service share, and a Jain fairness index
  over the shares — the numbers serve_bench.json publishes.

Wait-clock semantics: a bucket's wait counts *consecutive rounds it had
pending work but was not served*; serving it (or its queue emptying)
resets the clock. ``max_wait.get(bucket)`` is the lifetime maximum —
the starvation regression test pins it ≤ ``max_wait_rounds``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionRejected",
    "BucketDemand", "SLOClass", "DEFAULT_SLO_CLASSES", "jain_index",
]


class AdmissionRejected(RuntimeError):
    """Backpressure: the waiting set is full; defer or drop the stream."""


def jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index over non-negative allocations:
    ``(sum x)^2 / (n * sum x^2)``. 1.0 = perfectly fair (all equal),
    1/n = maximally unfair (one allocation gets everything). Empty or
    all-zero input reads as fair (nothing is being divided)."""
    xs = [float(x) for x in xs]
    if not xs:
        return 1.0
    total = sum(xs)
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0
    return (total * total) / (len(xs) * sq)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A per-stream service class (see module docstring).

    ``weight`` >= 1 biases scheduling toward the class (group ordering
    and effective queue depth for the elastic-B resize); weights < 1
    de-prioritize ordering but never shrink a bucket's effective depth
    below its true depth (bulk streams must not slow their own bucket's
    batch below what the queue needs). ``max_wait_rounds`` (optional)
    tightens the aging bound for buckets where the class is waiting.
    """

    name: str
    weight: float = 1.0
    max_wait_rounds: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"SLO weight must be > 0, got {self.weight}")
        if self.max_wait_rounds is not None and self.max_wait_rounds < 1:
            raise ValueError(f"SLO max_wait_rounds must be >= 1, got "
                             f"{self.max_wait_rounds}")


STANDARD_SLO = SLOClass("standard", weight=1.0)
INTERACTIVE_SLO = SLOClass("interactive", weight=4.0, max_wait_rounds=1)
BULK_SLO = SLOClass("bulk", weight=0.25)
DEFAULT_SLO_CLASSES = (STANDARD_SLO, INTERACTIVE_SLO, BULK_SLO)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs for the round planner + backpressure (module docstring)."""

    max_wait_rounds: int = 4            # aging bound (rounds)
    max_waiting: Optional[int] = None   # backpressure: waiting-set bound
    max_groups_per_round: Optional[int] = None  # None: all buckets w/ work
    mode: str = "mixed"                 # "mixed" | "drain" (legacy)
    slo_classes: Tuple[SLOClass, ...] = DEFAULT_SLO_CLASSES

    def __post_init__(self):
        if self.mode not in ("mixed", "drain"):
            raise ValueError(f"mode must be 'mixed' or 'drain', got "
                             f"{self.mode!r}")
        if self.max_wait_rounds < 1:
            raise ValueError(f"max_wait_rounds must be >= 1, got "
                             f"{self.max_wait_rounds}")
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1, got "
                             f"{self.max_waiting}")
        if self.max_groups_per_round is not None \
                and self.max_groups_per_round < 1:
            raise ValueError(f"max_groups_per_round must be >= 1, got "
                             f"{self.max_groups_per_round}")
        names = [c.name for c in self.slo_classes]
        if len(names) != len(set(names)) or not names:
            raise ValueError(f"slo_classes need unique names, got {names}")

    def slo(self, name: Optional[str]) -> SLOClass:
        """Class by name; None -> the first (default) class."""
        if name is None:
            return self.slo_classes[0]
        for c in self.slo_classes:
            if c.name == name:
                return c
        raise KeyError(f"unknown SLO class {name!r}; known: "
                       f"{[c.name for c in self.slo_classes]}")


@dataclasses.dataclass
class BucketDemand:
    """One scene bucket's demand snapshot for ``plan_round``.

    ``depth`` counts streams wanting service (bound to a slot, or
    waiting with pending poses); ``pending`` counts streams with poses
    actually queued (what a round could render); ``bound`` counts slots
    currently occupied (the drain mode's in-flight signal). ``weight``
    is the max SLO weight among wanting streams, ``weighted_depth`` the
    SLO-inflated depth the elastic-B resize uses, and ``wait_bound``
    the tightest per-class ``max_wait_rounds`` among waiting streams
    (None: use the config bound). ``order`` is the smallest session id
    wanting service — the oldest-first tiebreak.
    """

    depth: int = 0
    pending: int = 0
    bound: int = 0
    weight: float = 1.0
    weighted_depth: float = 0.0
    wait_bound: Optional[int] = None
    order: float = math.inf


class AdmissionController:
    """Round planning + backpressure + fairness accounting.

    ``metrics`` (optional) is the serve stack's shared
    ``MetricsRegistry`` (repro/obs/metrics.py): the controller publishes
    its backpressure counter and per-bucket wait gauges there so one
    ``snapshot()`` covers admission next to the server's own metrics.
    A standalone controller gets a private registry — no None checks.
    """

    def __init__(self, cfg: AdmissionConfig = AdmissionConfig(),
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._m_deferred = self.metrics.counter(
            "serve_deferrals_total",
            "offer() refusals: arrivals deferred by backpressure")
        # Consecutive rounds each bucket had pending work but was not
        # served (the aging clock), and the lifetime max of that clock.
        self._wait: Dict[Hashable, int] = {}
        self.max_wait: Dict[Hashable, int] = {}
        self.demand_rounds: Dict[Hashable, int] = {}
        self.served_rounds: Dict[Hashable, int] = {}
        self.frames_served: Dict[Hashable, int] = {}

    @property
    def deferred(self) -> int:
        """Lifetime offer() refusals (backpressure events)."""
        return int(self._m_deferred.value)

    # -- backpressure --------------------------------------------------------
    def offer(self, waiting_now: int) -> bool:
        """May one more stream join the waiting set? False = defer/reject
        (counted — a deferred arrival retried next round counts again)."""
        if self.cfg.max_waiting is not None \
                and waiting_now >= self.cfg.max_waiting:
            self._m_deferred.inc()
            return False
        return True

    # -- round planning ------------------------------------------------------
    def wait_of(self, bucket: Hashable) -> int:
        return self._wait.get(bucket, 0)

    def _effective_bound(self, d: BucketDemand) -> int:
        if d.wait_bound is None:
            return self.cfg.max_wait_rounds
        return min(self.cfg.max_wait_rounds, d.wait_bound)

    def plan_round(self, demand: Dict[Hashable, BucketDemand]
                   ) -> List[Hashable]:
        """The ordered scene buckets this round serves.

        ``demand`` iteration order is the server's bucket discovery
        order (stable across rounds for stable session sets).
        """
        if self.cfg.mode == "drain":
            # Legacy drain-before-switch: the in-flight bucket while any
            # slot is bound, else the oldest waiting bucket. No aging —
            # this is the starvation baseline the replay demonstrates.
            for b, d in demand.items():
                if d.bound > 0:
                    return [b]
            cand = [b for b, d in demand.items() if d.pending > 0]
            if not cand:
                return []
            return [min(cand, key=lambda b: demand[b].order)]

        cand = [b for b, d in demand.items() if d.pending > 0]
        # Aged buckets first (skipping one would break the wait bound),
        # then by SLO-weighted wait, oldest stream as the tiebreak.
        def key(b):
            d = demand[b]
            w = self._wait.get(b, 0)
            aged = (w + 1) >= self._effective_bound(d)
            return (not aged, -(w + 1) * d.weight, d.order)
        cand.sort(key=key)
        cap = self.cfg.max_groups_per_round
        return cand if cap is None else cand[:cap]

    def note_round(self, demand: Dict[Hashable, BucketDemand],
                   served: Sequence[Hashable]) -> None:
        """Advance the wait clocks after a round: buckets with pending
        work that went unserved age by one; served (or emptied) buckets
        reset."""
        served = set(served)
        for b, d in demand.items():
            if d.pending <= 0:
                self._wait[b] = 0
                continue
            self.demand_rounds[b] = self.demand_rounds.get(b, 0) + 1
            if b in served:
                self.served_rounds[b] = self.served_rounds.get(b, 0) + 1
                self._wait[b] = 0
            else:
                w = self._wait.get(b, 0) + 1
                self._wait[b] = w
                self.max_wait[b] = max(self.max_wait.get(b, 0), w)
                self.metrics.gauge(
                    "serve_bucket_max_wait_rounds",
                    "lifetime max consecutive unserved rounds with "
                    "pending work", bucket=str(b)).set_max(w)

    def record_service(self, bucket: Hashable, frames: int) -> None:
        self.frames_served[bucket] = \
            self.frames_served.get(bucket, 0) + int(frames)

    # -- fairness ------------------------------------------------------------
    def shares(self) -> Dict[Hashable, float]:
        """Per-bucket service share: served rounds / rounds with demand."""
        return {b: (self.served_rounds.get(b, 0) / n if n else 1.0)
                for b, n in self.demand_rounds.items()}

    def report(self) -> dict:
        shares = self.shares()
        return {
            "mode": self.cfg.mode,
            "max_wait_rounds_config": self.cfg.max_wait_rounds,
            "jain_service": round(jain_index(list(shares.values())), 4),
            "max_wait_rounds": max(self.max_wait.values(), default=0),
            "deferred": self.deferred,
            "per_bucket": {
                str(b): {
                    "demand_rounds": self.demand_rounds.get(b, 0),
                    "served_rounds": self.served_rounds.get(b, 0),
                    "frames": self.frames_served.get(b, 0),
                    "max_wait_rounds": self.max_wait.get(b, 0),
                    "share": round(shares.get(b, 1.0), 4),
                } for b in self.demand_rounds},
        }
