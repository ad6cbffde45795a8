"""Spans for the serve stack and the frame's stages, one mechanism for the
host trace, ``torch.profiler`` and NVTX (port of ``repro/obs/trace.py``).

``Tracer.span(name)`` opens one range through three sinks, each only
while someone listens:

- a ``torch.profiler.record_function`` range named ``prefix + name``
  while a torch profiler is collecting (otherwise the cost is one
  ``_profiler_enabled()`` check), so a device trace attributes kernels
  and idle gaps to the program's stages;
- while the tracer is enabled, one Chrome-trace complete ``"X"`` event
  (timed with ``time.perf_counter_ns``) on a named track (one ``tid``
  per track), and, on a host with a GPU, an NVTX range of the same name
  for an operator running Nsight Systems.

With neither listening, ``span()`` returns a shared no-op context
manager. The buffer keeps the earliest ``keep`` events and counts the
rest in ``dropped``; ``async_span`` records a begin/end pair (Chrome
``"b"``/``"e"``) of an interval that is known only after it ended, such
as a frame's wait in the admission queue.

``annotate(name, args)`` is a span of the process-wide ``PROCESS_TRACER``
(disabled by default; set ``PROCESS_TRACER.enabled = True`` to record the
frame's stages), on one track per host thread. ``to_chrome()`` writes
the tracer's clock anchor into ``otherData["clock"]`` and
``merge_chrome_traces`` uses it to lay a host trace over a profiler
trace on the profiler's time base. ``validate_chrome_trace`` checks an
exported trace's well-formedness. Metadata only: numerics are unchanged.
"""
from __future__ import annotations

import functools
import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "PROCESS_TRACER", "Tracer", "annotate",
    "merge_chrome_traces", "validate_chrome_trace",
]

_profiling = torch._C._autograd._profiler_enabled


@functools.lru_cache(maxsize=None)
def _has_nvtx() -> bool:
    return torch.cuda.is_available()


class _NullSpan:
    """Shared no-op context manager returned when nobody listens."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: a profiler range and/or a recorded event."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_record", "_rf",
                 "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 args: Optional[dict], record: bool, profile: bool):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args
        self._record = record
        self._rf = torch.profiler.record_function(tracer.prefix + name) \
            if profile else None

    def __enter__(self):
        if self._record:
            self._t0 = time.perf_counter_ns()
            if _has_nvtx():
                torch.cuda.nvtx.range_push(self._tracer.prefix + self._name)
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if self._record:
            if _has_nvtx():
                torch.cuda.nvtx.range_pop()
            t1 = time.perf_counter_ns()
            track = self._track if self._track is not None \
                else f"thread {threading.current_thread().name}"
            # args are copied at exit: a caller may add to its dict while
            # the span is open (a round's frame counts).
            self._tracer._emit_complete(self._name, track, self._t0, t1,
                                        self._args)
        return False


class Tracer:
    """Bounded, thread-safe span recorder with Chrome-trace export.

    ``span(name, track=..., args=...)`` is the whole API surface the
    serve loop uses; ``instant`` marks point events (e.g. a batcher
    resize) and ``async_span`` intervals known after the fact. Tracks are
    created on first use; every distinct ``track`` string becomes one
    Chrome-trace thread row. ``prefix`` is put before a span's name in
    the profiler and NVTX (``"repro.serve/"`` for the server's spans);
    the host trace keeps the bare name.
    """

    KEEP = 65536        # default event-buffer bound
    PID = 1             # single logical process in the trace

    def __init__(self, enabled: bool = False, keep: int = KEEP,
                 prefix: str = ""):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.enabled = bool(enabled)
        self.keep = int(keep)
        self.prefix = str(prefix)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tracks: Dict[str, int] = {}
        # One clock zero per tracer: ts fields are microseconds since
        # construction, so traces from one server share an origin. The
        # Unix time read beside it anchors the zero for merging with a
        # profiler trace (which stamps Unix-epoch microseconds).
        self._t0_ns = time.perf_counter_ns()
        self._unix_ns = time.time_ns()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, track: Optional[str] = "main",
             args: Optional[dict] = None):
        """Context manager over its body (module docstring). ``track``
        None is the calling thread's own track."""
        profile = _profiling()
        if not (self.enabled or profile):
            return _NULL_SPAN
        return _Span(self, name, track, args, self.enabled, profile)

    def instant(self, name: str, track: str = "main",
                args: Optional[dict] = None) -> None:
        """A point event (Chrome-trace ``"i"``, thread-scoped)."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": (now - self._t0_ns) / 1e3,
              "pid": self.PID, "tid": self._track_id(track)}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def async_span(self, name: str, t0_s: float, t1_s: float, span_id: str,
                   track: str = "main", args: Optional[dict] = None) -> None:
        """An interval ``[t0_s, t1_s]`` of ``time.perf_counter()`` seconds
        as a Chrome async pair (``"b"``/``"e"`` with ``id`` ``span_id``):
        such intervals may overlap on one track."""
        if not self.enabled:
            return
        tid = self._track_id(track)
        for ph, t in (("b", t0_s), ("e", t1_s)):
            ev = {"name": name, "ph": ph, "cat": name, "id": span_id,
                  "ts": (t * 1e9 - self._t0_ns) / 1e3, "pid": self.PID,
                  "tid": tid}
            if args and ph == "b":
                ev["args"] = dict(args)
            self._append(ev)

    def _emit_complete(self, name: str, track: str, t0_ns: int, t1_ns: int,
                       args: Optional[dict]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0_ns - self._t0_ns) / 1e3,
              "dur": (t1_ns - t0_ns) / 1e3,
              "pid": self.PID, "tid": self._track_id(track)}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def _track_id(self, track: str) -> int:
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
        it can't be squeezed out by the bound); ``otherData`` carries the
        drop accounting and the clock anchor (``perf_counter_ns`` and
        ``unix_ns`` of ts = 0).
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
                "otherData": {"events": len(events), "dropped": dropped,
                              "clock": {"perf_counter_ns": self._t0_ns,
                                        "unix_ns": self._unix_ns}}}

    def write(self, path: str) -> int:
        """Serialize to ``path``; returns the recorded-event count."""
        trace = self.to_chrome()
        with open(path, "w") as f:
            json.dump(trace, f, indent=1)
        return int(trace["otherData"]["events"])


# The process-wide tracer: ``annotate``'s frame stages, and the spans of
# components built without a tracer of their own (so their span lines
# need no None checks).
PROCESS_TRACER = Tracer(enabled=False)


def annotate(name: str, args: Optional[dict] = None):
    """A span of ``PROCESS_TRACER`` on the calling thread's track: names a
    stage for ``torch.profiler`` and, when the tracer records, for the
    host trace and NVTX."""
    return PROCESS_TRACER.span(name, track=None, args=args)


def merge_chrome_traces(host: dict, profiler: dict) -> dict:
    """A profiler's exported trace with ``host``'s events (a
    ``Tracer.to_chrome()``) laid over it on the profiler's time base.

    The profiler stamps Unix-epoch microseconds less
    ``baseTimeNanoseconds``; the host trace's clock anchor gives the Unix
    time of its zero. The host events take a process id the profiler's
    trace does not use.
    """
    shift = (host["otherData"]["clock"]["unix_ns"]
             - profiler.get("baseTimeNanoseconds", 0)) / 1e3
    pids = [e["pid"] for e in profiler["traceEvents"]
            if isinstance(e.get("pid"), int)]
    pid = max(pids, default=0) + 1
    moved = []
    for ev in host["traceEvents"]:
        ev = dict(ev, pid=pid)
        if "ts" in ev:
            ev["ts"] = ev["ts"] + shift
        moved.append(ev)
    return dict(profiler, traceEvents=list(profiler["traceEvents"]) + moved)


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
