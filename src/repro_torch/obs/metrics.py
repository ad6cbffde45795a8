"""Metrics registry: counters, gauges, histograms, one snapshot (the
port's own copy of ``repro/obs/metrics.py``, which has no JAX in it).

- **Counter** — monotone accumulator (``serve_frames_total``); floats
  allowed (``serve_render_seconds_total`` accumulates wall seconds).
- **Gauge** — last-written value; ``set_max`` keeps a running maximum.
- **Histogram** — lifetime ``count``/``sum``/``min``/``max`` plus a
  bounded newest-``keep`` reservoir for percentiles. An empty histogram
  reports ``None`` percentiles, never NaN.

Metrics are keyed by ``(name, labels)``. ``snapshot()`` returns one
plain-types dict (JSON-safe; ``StreamServer.report`` composes it) and
``to_prometheus()`` renders the text exposition format. One registry
lock guards creation, mutation and export.

``PROCESS_METRICS`` is the process-wide registry of what the program
counts outside any server: ``kernel_launches_total{kernel=...}``, each
hand-written kernel's launches (``kernel_launches``). A site creates its
counter once, when its module is imported, so a count is one locked add.
"""
from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "PROCESS_METRICS", "kernel_launches"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class _Metric:
    """Shared identity: name + frozen labels (sorted key-value pairs)."""

    __slots__ = ("name", "labels", "help", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 help: str, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = lock

    @property
    def key(self) -> str:
        return self.name + _label_str(self.labels)


class Counter(_Metric):
    """Monotone accumulator; ``inc`` rejects negative deltas."""

    __slots__ = ("_value",)

    def __init__(self, *a):
        super().__init__(*a)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.key} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    """Last-written value; ``set_max`` keeps a running maximum."""

    __slots__ = ("_value",)

    def __init__(self, *a):
        super().__init__(*a)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_max(self, v: float) -> None:
        with self._lock:
            self._value = max(self._value, float(v))

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Metric):
    """Lifetime count/sum/min/max + bounded newest-``keep`` reservoir.

    The exact aggregates are lifetime-accurate no matter how long the
    server runs; percentiles are over the newest ``keep`` observations
    (the same recency trade the serve latency reservoirs make). Empty
    histograms report ``None`` percentiles — never NaN, never raise.
    """

    __slots__ = ("keep", "count", "total", "vmin", "vmax", "_reservoir")

    def __init__(self, name, labels, help, lock, keep: int = 4096):
        super().__init__(name, labels, help, lock)
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.keep = int(keep)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._reservoir: Deque[float] = deque(maxlen=self.keep)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
            self._reservoir.append(v)

    def observe_many(self, vs: Sequence[float]) -> None:
        arr = np.asarray(vs, dtype=np.float64).reshape(-1)
        if arr.size == 0:
            return
        with self._lock:
            self.count += int(arr.size)
            self.total += float(arr.sum())
            self.vmin = min(self.vmin, float(arr.min()))
            self.vmax = max(self.vmax, float(arr.max()))
            self._reservoir.extend(arr.tolist())

    def values(self) -> List[float]:
        """Snapshot of the reservoir (newest ``keep`` observations)."""
        with self._lock:
            return list(self._reservoir)

    def percentile(self, q: float) -> Optional[float]:
        """Reservoir percentile, or None when nothing has been observed."""
        with self._lock:
            if not self._reservoir:
                return None
            return float(np.percentile(np.asarray(self._reservoir), q))

    def stats(self) -> dict:
        with self._lock:
            res = np.asarray(self._reservoir) if self._reservoir else None
            out = {
                "count": self.count,
                "sum": round(self.total, 6),
                "min": None if self.count == 0 else self.vmin,
                "max": None if self.count == 0 else self.vmax,
                "kept": 0 if res is None else int(res.size),
            }
        for q in (50, 90, 99):
            out[f"p{q}"] = None if res is None \
                else round(float(np.percentile(res, q)), 6)
        return out


class MetricsRegistry:
    """Get-or-create registry over the three instrument kinds.

    ``counter``/``gauge``/``histogram`` return the existing instrument
    for a ``(name, labels)`` pair (raising if it was registered as a
    different kind), so call sites never coordinate creation.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            _Metric] = {}

    def _get(self, cls, name: str, help: str, labels: dict, **kwargs):
        key = (str(name), tuple(sorted((str(k), str(v))
                                       for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(key[0], key[1], help, self._lock, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {m.key} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", keep: int = 4096,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, keep=keep)

    def family(self, name: str) -> Dict[str, float]:
        """``{label values joined by ",": value}`` of the counters and
        gauges registered under ``name`` (one label: its value)."""
        with self._lock:
            return {",".join(v for _, v in m.labels): m.value
                    for (n, _), m in self._metrics.items()
                    if n == name and isinstance(m, (Counter, Gauge))}

    def _by_kind(self):
        with self._lock:
            metrics = list(self._metrics.values())
        counters = [m for m in metrics if isinstance(m, Counter)]
        gauges = [m for m in metrics if isinstance(m, Gauge)]
        hists = [m for m in metrics if isinstance(m, Histogram)]
        return counters, gauges, hists

    def snapshot(self) -> dict:
        """One JSON-safe dict over every registered instrument.

        Counters/gauges map ``key -> value`` (ints stay ints);
        histograms map ``key -> {count, sum, min, max, p50, p90, p99,
        kept}`` with None (not NaN) percentiles when empty.
        """
        counters, gauges, hists = self._by_kind()

        def num(v: float):
            return int(v) if float(v).is_integer() else round(v, 6)

        return {
            "counters": {m.key: num(m.value) for m in counters},
            "gauges": {m.key: num(m.value) for m in gauges},
            "histograms": {m.key: m.stats() for m in hists},
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters/gauges verbatim,
        histograms as summaries (reservoir quantiles + lifetime
        ``_sum``/``_count``)."""
        counters, gauges, hists = self._by_kind()
        lines: List[str] = []
        seen_header = set()

        def header(name: str, kind: str, help: str):
            if name in seen_header:
                return
            seen_header.add(name)
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")

        for m in counters:
            name = _prom_name(m.name)
            header(name, "counter", m.help)
            lines.append(f"{name}{_label_str(m.labels)} {m.value:g}")
        for m in gauges:
            name = _prom_name(m.name)
            header(name, "gauge", m.help)
            lines.append(f"{name}{_label_str(m.labels)} {m.value:g}")
        for m in hists:
            name = _prom_name(m.name)
            header(name, "summary", m.help)
            for q in (0.5, 0.9, 0.99):
                v = m.percentile(100.0 * q)
                if v is not None:
                    labels = m.labels + (("quantile", f"{q:g}"),)
                    lines.append(f"{name}{_label_str(labels)} {v:g}")
            lines.append(f"{name}_sum{_label_str(m.labels)} {m.total:g}")
            lines.append(f"{name}_count{_label_str(m.labels)} {m.count}")
        return "\n".join(lines) + "\n"


PROCESS_METRICS = MetricsRegistry()


def kernel_launches(kernel: str) -> Counter:
    """The process's count of ``kernel``'s launches."""
    return PROCESS_METRICS.counter(
        "kernel_launches_total", "hand-written kernel launches",
        kernel=kernel)
