"""What the benchmark reads from a traced slice of a run.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activity) and reduces the trace to a ``Slice``: the wall time of the
slice, the seconds a device operation ran (the union of their
intervals), each device operation's time under every annotated stage of
the program that launched it (``obs/trace.annotate`` ranges such as
``repro.frame/intersect``), the device operations that took most time,
and the idle gaps by what the host was doing when they began.

``host_syncs(fn)`` counts the operations that made the host wait for
the device, by torch's CUDA sync debug mode.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
import traceback
import warnings
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Slice(NamedTuple):
    wall_s: float                    # host clock, first call to last sync
    busy_s: float                    # union of device operations
    stage_s: Dict[str, float]        # annotation name -> device seconds
    op_s: Dict[str, float]           # device operation name -> seconds
    gaps: List[Tuple[str, float]]    # (host activity, seconds) per gap
    device_ops: int                  # device operations run


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profiled(fn: Callable[[], object]) -> Tuple[object, Slice]:
    """Run ``fn`` under the profiler; returns (its result, the slice)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, reduce_events(events, wall)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _enclosing(ranges, points):
    """For start-sorted, properly nested ``(start, end, name)`` ranges of
    one thread, the names holding each of ``points``, outermost first."""
    out = [[] for _ in points]
    stack: list = []
    j = 0
    for at, k in sorted((p, k) for k, p in enumerate(points)):
        while j < len(ranges) and ranges[j][0] <= at:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < at:
            stack.pop()
        out[k] = [r[2] for r in stack if r[1] >= at]
    return out


def reduce_events(events: List[dict], wall_s: float) -> Slice:
    """Chrome-trace events of one profiled slice -> ``Slice``."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    launch = {}
    annotations = defaultdict(list)
    host_ops = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["pid"], e["tid"], float(e["ts"]))
        elif cat == "user_annotation":
            annotations[(e["pid"], e["tid"])].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))
        elif cat == "cpu_op":
            host_ops[(e["pid"], e["tid"])].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))
    for table in (annotations, host_ops):
        for spans in table.values():
            spans.sort()
    stage = defaultdict(float)
    op = defaultdict(float)
    spans = []
    by_thread = defaultdict(list)
    for e in dev:
        dur = float(e.get("dur", 0.0))
        spans.append((float(e["ts"]), float(e["ts"]) + dur))
        op[e["name"]] += dur / 1e6
        at = launch.get(e.get("args", {}).get("correlation"))
        if at is not None:
            by_thread[at[:2]].append((at[2], dur))
    for thread, items in by_thread.items():
        names = _enclosing(annotations.get(thread, []),
                           [t for t, _ in items])
        for (_, dur), held in zip(items, names):
            for name in set(held):
                stage[name] += dur / 1e6
    busy = _union(spans)
    # The host thread that launched most device work is the one whose
    # activity explains an idle gap.
    threads = defaultdict(int)
    for pid, tid, _ in launch.values():
        threads[(pid, tid)] += 1
    main = max(threads, key=threads.get) if threads else None
    gaps = []
    idle = [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])
            if nxt > end]
    if main is not None and idle:
        starts = [end for end, _ in idle]
        held = _enclosing(annotations.get(main, []), starts)
        ops = _enclosing(host_ops.get(main, []), starts)
        for (end, nxt), names, inside in zip(idle, held, ops):
            inner = [n for n in names if n.startswith("repro.")]
            label = (inner[-1] if inner else "host") + \
                (f" / {inside[-1]}" if inside else "")
            gaps.append((label, (nxt - end) / 1e6))
    return Slice(wall_s=wall_s,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 stage_s=dict(stage), op_s=dict(op), gaps=gaps,
                 device_ops=len(dev))


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The slice's device operations that took most time, and its idle
    time summed by what the host was doing, each list ``top`` long."""
    gap_s = defaultdict(float)
    for label, sec in sl.gaps:
        gap_s[label] += sec
    ops = sorted(sl.op_s.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gap_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def host_syncs(fn: Callable[[], object]) -> Tuple[object, Dict[str, int]]:
    """Run ``fn`` under torch's CUDA sync debug mode; returns (its result,
    {where: count} of the operations that made the host wait for the
    device), each place named by its innermost frame outside the
    installed packages, with the torch frame that warned."""
    where: Dict[str, int] = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "-packages" not in f.filename
                and "/lib/python" not in f.filename]
        at = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}"
              if ours else "?") + f" ({os.path.basename(filename)}:{lineno})"
        where[at] = where.get(at, 0) + 1

    if not torch.cuda.is_available():
        return fn(), where
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, where
