"""The port's observability (``repro_torch.obs``): one span mechanism for
the host trace and ``torch.profiler``, the server's queue-wait and round
histograms, and the process's kernel-launch counters. All on
the CPU; nothing here imports JAX."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engine
from repro_torch.core.camera import look_at, make_camera
from repro_torch.core.pipeline import RenderConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import (PROCESS_METRICS, MetricsRegistry,
                                     kernel_launches)
from repro_torch.obs.trace import (PROCESS_TRACER, Tracer, annotate,
                                   merge_chrome_traces,
                                   validate_chrome_trace)
from repro_torch.scenes.synthetic import structured_scene
from repro_torch.scenes.trajectory import dolly_trajectory
from repro_torch.serve import SceneRegistry, ServeConfig, StreamServer

CPU = "cpu"
CFG = RenderConfig(window=3, capacity=128, chunk=32, rerender_capacity=8,
                   impl="cuda")


@pytest.fixture(scope="module")
def scene():
    return structured_scene(9, 260, clutter=0.4, device=CPU)


@pytest.fixture(scope="module")
def cam():
    return make_camera(look_at((0.0, -0.3, -2.0), (0.0, 0.0, 6.0),
                               device=CPU), width=48, height=48, device=CPU)


@pytest.fixture
def process_tracer():
    """``PROCESS_TRACER`` recording for one test, left as it was found."""
    was = PROCESS_TRACER.enabled
    PROCESS_TRACER.enabled = True
    yield PROCESS_TRACER
    PROCESS_TRACER.enabled = was


def _poses(n, dx=0.0):
    return dolly_trajectory(n, start=(dx, -0.3, -2.0),
                            target=(0.0, 0.0, 6.0), device=CPU).numpy()


def _server(scene, cam, trace=False, **kw):
    reg = SceneRegistry((512,), device=CPU)
    entry = reg.register(scene)
    scfg = ServeConfig(slots=2, chunk=2, r_buckets=(8,),
                       scene_buckets=(512,), trace=trace, **kw)
    return StreamServer(reg, cam, CFG, scfg, device=CPU), entry


def _profiler_trace(prof, tmp_path):
    path = tmp_path / "profiler.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


# --- one span mechanism -----------------------------------------------------

def test_spans_are_profiler_ranges_on_one_clock(tmp_path):
    """Inside a profiler, a ``Tracer.span`` and an ``annotate`` appear as
    ``user_annotation`` events under their names (the tracer's prefix
    before the span's), and the host trace's span, shifted by the exported
    clock anchor, starts within 1 ms of the profiler's."""
    tr = Tracer(enabled=True, prefix="repro.test/")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer", track="round", args={"round": 1}):
            with annotate("repro.test/stage"):
                torch.ones(64).sum()
    events = _profiler_trace(prof, tmp_path)
    ranges = {e["name"]: e for e in events["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"repro.test/outer", "repro.test/stage"} <= set(ranges)
    merged = merge_chrome_traces(tr.to_chrome(), events)
    host = [e for e in merged["traceEvents"]
            if e.get("name") == "outer" and e.get("ph") == "X"]
    assert len(host) == 1 and host[0]["args"] == {"round": 1}
    assert abs(host[0]["ts"] - ranges["repro.test/outer"]["ts"]) < 1e3
    assert host[0]["pid"] not in {e["pid"] for e in events["traceEvents"]}
    clock = tr.to_chrome()["otherData"]["clock"]
    assert set(clock) == {"perf_counter_ns", "unix_ns"}


def test_no_listener_opens_no_record_function(monkeypatch, scene, cam):
    """With no profiler and the tracer off, no span opens a
    ``record_function`` range: not a frame's stages, not the server's
    spans. Under a profiler every span does."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not PROCESS_TRACER.enabled
    srv, entry = _server(scene, cam)
    srv.attach(_poses(4), scene_id=entry.scene_id)
    assert srv.run(max_rounds=10)["streams_finished"] == 1
    with annotate("repro.test/idle"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        srv.attach(_poses(4), scene_id=entry.scene_id)
        srv.run(max_rounds=10)
    assert "repro.serve/round" in opened and "repro.frame/full" in opened
    assert "repro.frame/intersect" in opened


def test_disabled_tracer_returns_the_shared_null_span():
    tr = Tracer(enabled=False)
    assert tr.span("a") is tr.span("b", args={"x": 1}) is \
        annotate("repro.test/x")
    tr.async_span("wait", 1.0, 2.0, "1.0")
    assert tr.events() == []


def test_tracing_observer_effect_zero(scene, cam, process_tracer):
    """Tracing on (the server's tracer and the process tracer) and off:
    bit-identical frames through identical executable-cache keys."""
    frames, keys = {}, {}
    for on in (False, True):
        process_tracer.enabled = on
        srv, entry = _server(scene, cam, trace=on, collect_frames=True)
        sessions = [srv.attach(_poses(5, dx=0.05 * i),
                               scene_id=entry.scene_id) for i in range(2)]
        report = srv.run(max_rounds=20)
        assert report["streams_finished"] == 2
        frames[on] = [torch.cat(s.frames) for s in sessions]
        keys[on] = sorted(report["cache"]["keys"])
    assert keys[False] == keys[True]
    for a, b in zip(frames[False], frames[True]):
        assert torch.equal(a, b)


def test_frame_spans_carry_stream_step_and_key(scene, cam, process_tracer):
    """The process tracer records a frame's span with its stream, step
    and key-frame flag, its stages nested inside on the thread's track."""
    start = len(process_tracer.events())
    poses = torch.from_numpy(_poses(4))
    engine.render_streams(scene, cam, poses[None].repeat(2, 1, 1, 1), CFG,
                          phases=[0, 1])
    events = process_tracer.events()[start:]
    frames = [e for e in events if e["name"] in ("repro.frame/full",
                                                 "repro.frame/sparse")]
    assert [(e["args"]["stream"], e["args"]["step"], e["args"]["key"])
            for e in frames] == [(0, 0, True), (0, 1, False),
                                 (0, 2, False), (0, 3, True),
                                 (1, 0, True), (1, 1, False),
                                 (1, 2, True), (1, 3, False)]
    assert all(e["name"] == ("repro.frame/full" if e["args"]["key"]
                             else "repro.frame/sparse") for e in frames)
    first = frames[0]
    inside = [e for e in events if e["tid"] == first["tid"]
              and first["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= first["ts"] + first["dur"]]
    assert {"repro.frame/preprocess", "repro.frame/intersect",
            "repro.frame/raster"} <= {e["name"] for e in inside}
    validate_chrome_trace(process_tracer.to_chrome())


# --- the server's queue wait and round time ---------------------------------

def test_queue_wait_plus_round_time_is_latency(scene, cam):
    """Frames enqueued at known times on a server whose clock is scripted:
    each frame's queue wait plus its round's time equals its latency
    sample, and the round histogram holds one sample per busy round."""
    srv, entry = _server(scene, cam, trace=True)
    ticks = iter([10.0, 10.5, 11.0, 12.25, 13.0, 13.125, 14.0, 15.5])
    srv.clock = lambda: next(ticks)
    sess = srv.attach(_poses(1), now=9.0, scene_id=entry.scene_id)
    sess.closed = False
    sess.submit(_poses(3)[1:], now=9.5)
    sess.closed = True
    rounds = []
    while srv.manager.sessions:
        info = srv.step()
        if info["frames"]:
            rounds.append(info)
    hist = srv.metrics.snapshot()["histograms"]
    assert hist["serve_round_seconds"]["count"] == len(rounds) == 2
    m = {name: srv.metrics.histogram(name).values()
         for name in ("serve_queue_wait_seconds", "serve_round_seconds",
                      "serve_latency_seconds")}
    # Round 1 (t0 10.0, t1 10.5) renders the frames enqueued at 9.0 and
    # 9.5; round 2 (t0 11.0, t1 12.25) the third.
    assert m["serve_round_seconds"] == [0.5, 1.25]
    assert m["serve_queue_wait_seconds"] == [1.0, 0.5, 1.5]
    assert m["serve_latency_seconds"] == [1.5, 1.0, 2.75]
    per_frame_round = [0.5, 0.5, 1.25]
    for wait, rnd, lat in zip(m["serve_queue_wait_seconds"],
                              per_frame_round, m["serve_latency_seconds"]):
        assert wait + rnd == pytest.approx(lat, abs=1e-12)
    # Each frame's wait is an async span, id <session>.<frame>, that ends
    # where its round started; the round spans carry their frame counts.
    waits = [e for e in srv.tracer.events() if e["name"] == "queue_wait"]
    assert [(e["ph"], e["id"]) for e in waits] == [
        ("b", f"{sess.sid}.0"), ("e", f"{sess.sid}.0"),
        ("b", f"{sess.sid}.1"), ("e", f"{sess.sid}.1"),
        ("b", f"{sess.sid}.2"), ("e", f"{sess.sid}.2")]
    assert [e["args"]["round"] for e in waits if e["ph"] == "b"] == [1, 1, 2]
    rounds_ev = [e["args"] for e in srv.tracer.events()
                 if e["name"] == "round" and "frames" in e.get("args", {})]
    assert rounds_ev == [{"round": 1, "frames": 2, "key_frames": 1},
                         {"round": 2, "frames": 1, "key_frames": 0}]


def test_report_carries_the_new_histograms(scene, cam):
    srv, entry = _server(scene, cam)
    srv.attach(_poses(5), scene_id=entry.scene_id)
    report = srv.run(max_rounds=20)
    hist = report["metrics"]["histograms"]
    assert hist["serve_queue_wait_seconds"]["count"] == report["frames"]
    assert hist["serve_round_seconds"]["count"] == report["busy_rounds"]
    assert hist["serve_queue_wait_seconds"]["max"] <= \
        hist["serve_latency_seconds"]["max"]


# --- kernel launches -------------------------------------------------------

def test_process_counters_are_created_once():
    from repro_torch.kernels import (ldu_fill, preprocess,  # noqa: F401
                                     raster_plan, raster_tile, tile_sort)
    assert kernel_launches("raster_tile") is \
        PROCESS_METRICS.counter("kernel_launches_total", kernel="raster_tile")
    reg = MetricsRegistry()
    reg.counter("c", site="a").inc(2)
    reg.counter("c", site="b").inc()
    reg.histogram("c_hist").observe(1.0)
    assert reg.family("c") == {"a": 2.0, "b": 1.0}
    assert set(PROCESS_METRICS.family("kernel_launches_total")) >= {
        "raster_tile", "raster_plan_fused", "preprocess_geom", "tile_sort",
        "ldu_fill"}


def test_async_spans_export_and_validate():
    tr = Tracer(enabled=True)
    t = obs_trace.time.perf_counter()
    tr.async_span("queue_wait", t, t + 0.25, "3.7", track="queue",
                  args={"round": 4})
    chrome = tr.to_chrome()
    summary = validate_chrome_trace(chrome)
    assert summary["names"] == ["queue_wait"] and summary["spans"] == 0
    b, e = tr.events()
    assert (b["ph"], e["ph"], b["id"], e["id"]) == ("b", "e", "3.7", "3.7")
    assert e["ts"] - b["ts"] == pytest.approx(250e3)
    assert b["args"] == {"round": 4} and "args" not in e
    np.testing.assert_equal(b["tid"], e["tid"])
