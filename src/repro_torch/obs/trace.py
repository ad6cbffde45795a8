"""Span tracing for the serve stack and stage annotation for device
profiles (port of ``repro/obs/trace.py``).

``Tracer`` records context-manager spans (one Chrome-trace complete
``"X"`` event each, timed with ``time.perf_counter_ns``) onto named
tracks (one ``tid`` per track) and exports a JSON object that loads in
``chrome://tracing`` or Perfetto. Disabled (the default), ``span()``
returns a shared no-op context manager; enabled, a span costs two clock
reads and one locked append at exit. The buffer keeps the earliest
``keep`` events and counts the rest in ``dropped``.
``validate_chrome_trace`` checks an exported trace's well-formedness.

``annotate(name)`` opens a ``torch.profiler.record_function`` range (it
shows in ``torch.profiler`` traces) and, when a GPU is present, an NVTX
range of the same name. Metadata only: numerics are unchanged.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "NULL_TRACER", "Tracer", "annotate", "validate_chrome_trace",
]


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: timestamps on enter/exit, emits a complete event."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._emit_complete(self._name, self._track, self._t0, t1,
                                    self._args)
        return False


class Tracer:
    """Bounded, thread-safe span recorder with Chrome-trace export.

    ``span(name, track=..., args=...)`` is the whole API surface the
    serve loop uses; ``instant`` marks point events (e.g. a batcher
    resize). Tracks are created on first use; every distinct ``track``
    string becomes one Chrome-trace thread row.
    """

    KEEP = 65536        # default event-buffer bound
    PID = 1             # single logical process in the trace

    def __init__(self, enabled: bool = False, keep: int = KEEP):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.enabled = bool(enabled)
        self.keep = int(keep)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tracks: Dict[str, int] = {}
        # One clock zero per tracer: ts fields are microseconds since
        # construction, so traces from one server share an origin.
        self._t0_ns = time.perf_counter_ns()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, track: str = "main",
             args: Optional[dict] = None):
        """Context manager timing its body as one complete event."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, track, args)

    def instant(self, name: str, track: str = "main",
                args: Optional[dict] = None) -> None:
        """A point event (Chrome-trace ``"i"``, thread-scoped)."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": (now - self._t0_ns) / 1e3,
              "pid": self.PID, "tid": self._track_id(name=None, track=track)}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def _emit_complete(self, name: str, track: str, t0_ns: int, t1_ns: int,
                       args: Optional[dict]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0_ns - self._t0_ns) / 1e3,
              "dur": (t1_ns - t0_ns) / 1e3,
              "pid": self.PID, "tid": self._track_id(name=None, track=track)}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def _track_id(self, name, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.setdefault(track, len(self._tracks))
        return tid

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) < self.keep:
                self._events.append(ev)
            else:
                self.dropped += 1

    # -- export ------------------------------------------------------------
    def events(self) -> List[dict]:
        """Snapshot of the recorded events (no metadata rows)."""
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """The JSON-object trace: metadata + recorded events.

        Track-name metadata is synthesized at export (never buffered, so
        it can't be squeezed out by the bound), and ``otherData`` carries
        the drop accounting.
        """
        with self._lock:
            events = list(self._events)
            tracks = dict(self._tracks)
            dropped = self.dropped
        meta: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": self.PID, "tid": 0,
            "args": {"name": "repro-serve"}}]
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": self.PID,
                         "tid": tid, "args": {"name": track}})
            meta.append({"name": "thread_sort_index", "ph": "M",
                         "pid": self.PID, "tid": tid,
                         "args": {"sort_index": tid}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"events": len(events), "dropped": dropped}}

    def write(self, path: str) -> int:
        """Serialize to ``path``; returns the recorded-event count."""
        trace = self.to_chrome()
        with open(path, "w") as f:
            json.dump(trace, f, indent=1)
        return int(trace["otherData"]["events"])


# The module-level disabled tracer: components that take an optional
# tracer default to this, so their span lines need no None checks.
NULL_TRACER = Tracer(enabled=False)


@contextlib.contextmanager
def annotate(name: str):
    """Name a stage for ``torch.profiler`` and NVTX timelines."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def validate_chrome_trace(trace: Any) -> dict:
    """Well-formedness check for an exported trace; raises ``ValueError``.

    Contract (what tests and ``scripts/trace_summary.py --check``
    enforce): a dict with a ``traceEvents`` list; every event has
    ``name``/``ph``/``ts``/``pid``/``tid``; complete (``"X"``) events
    have ``dur >= 0``; and per track the X events observe stack
    discipline — sorted by start time, any two spans are disjoint or
    properly nested (a track is one thread of execution, so overlap
    means clock or pairing corruption). Returns summary counts:
    ``{"events", "spans", "tracks", "names"}``.
    """
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        raise ValueError("trace must be a dict with a traceEvents list")
    spans_by_track: Dict[tuple, List[tuple]] = {}
    names = set()
    n_spans = 0
    for i, ev in enumerate(trace["traceEvents"]):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        if ev["ph"] == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"event {i} missing 'ts': {ev}")
        if ev["ts"] < 0:
            raise ValueError(f"event {i} has negative ts: {ev}")
        names.add(ev["name"])
        if ev["ph"] == "X":
            if ev.get("dur", -1) < 0:
                raise ValueError(f"X event {i} needs dur >= 0: {ev}")
            n_spans += 1
            spans_by_track.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev["name"]))
    for track, spans in spans_by_track.items():
        spans.sort()
        stack: List[tuple] = []
        for t0, t1, name in spans:
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack and t1 > stack[-1][1]:
                raise ValueError(
                    f"track {track}: span {name!r} [{t0}, {t1}] overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]}] "
                    f"without nesting")
            stack.append((t0, t1, name))
    return {"events": sum(1 for ev in trace["traceEvents"]
                          if ev["ph"] != "M"),
            "spans": n_spans,
            "tracks": len(spans_by_track),
            "names": sorted(names)}
