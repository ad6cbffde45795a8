"""Port parity: the slot split over several devices
(``serve/placement.py``, the server's per-B placement) against the port's
plain path and the JAX reference, on the CPU.

The reference's ``test_sharded_streams_match_single_device`` and
``test_sharded_multi_scene_matches_single_device`` ported: B = 8 slots of
F = 4 frames (ragged counts, staggered phases; four scenes in contiguous
groups for the multi-scene run) split over ``("cpu",) * D`` for D = 2, 4
and 8 against the port's plain ``render_streams``: frames within 1e-5,
every record field and ``frame_active`` exactly, carries within 1e-5
(their step exactly). Groups on distinct devices run in threads of their
own (``cpu:0`` .. ``cpu:3``), with the same result.

Against the reference, in one process of its own on 8 forced host
devices (``_torch_placement_reference.py``, started first; it makes the
reference tests' scenes and poses once and hands them over in an npz,
then runs while the port's side runs here on one torch thread): the 8-way split within the port's parity
tolerance (frames and float carries 1e-4, records exactly), the
``stream_mesh`` device counts for 1-12 slots over 1-8 devices, and a
``StreamServer`` with 8 slots over 4 devices on a replayed trace (rounds,
the batcher's packing of same-scene streams into groups of B/D = 2,
per-session frames within 1e-4, ``num_devices``).
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import _torch_parity as P
import _torch_placement_inputs as I
from repro.core.camera import look_at as jlook_at, make_camera as jmake_camera
from repro_torch import serve as tserve
from repro_torch.core import engine as tengine
from repro_torch.core.pipeline import RenderConfig as TRenderConfig
from repro_torch.obs.metrics import MetricsRegistry

HERE = os.path.dirname(os.path.abspath(__file__))
SPLIT_ATOL = 1e-5
TRAJ_ATOL = 1e-4
CPU = "cpu"
MODES = ("single", "multi")


class Reference:
    """The reference process, started once for the module. ``inputs``
    waits for the scenes and poses it makes first; ``get()`` waits for
    it to end and returns its results' npz as a dict."""

    def __init__(self, tmp):
        self.inputs_path = os.path.join(tmp, "inputs.npz")
        self.path = os.path.join(tmp, "reference.npz")
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(HERE, "..", "src"), HERE,
                        os.environ.get("PYTHONPATH", "")]),
                   JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE,
                                          "_torch_placement_reference.py"),
             self.inputs_path, self.path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = self._inputs = None

    @property
    def inputs(self):
        deadline = time.monotonic() + 600
        while self._inputs is None:
            if os.path.exists(self.inputs_path):
                with np.load(self.inputs_path) as f:
                    self._inputs = {k: f[k] for k in f.files}
            elif self.proc.poll() is not None or time.monotonic() > deadline:
                self.get()
                raise AssertionError("the reference process wrote no inputs")
            else:
                time.sleep(0.2)
        return self._inputs

    def get(self):
        if self.out is None:
            _, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            with np.load(self.path) as f:
                self.out = {k: f[k] for k in f.files}
        return self.out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference process, running while the port's side runs here on
    one torch thread (torch's thread team and XLA's, spinning side by side
    on the same cores, slow each other by far more than one thread costs
    at 48 x 48)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ref = Reference(str(tmp_path_factory.mktemp("placement")))
    yield ref
    torch.set_num_threads(threads)
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


pytestmark = pytest.mark.usefixtures("reference")


def _camera():
    return P.camera(jmake_camera(jlook_at(*I.CAM_LOOK), width=I.SIZE,
                                 height=I.SIZE))


def _scene(reference, name):
    return P.scene([reference.inputs[f"{name}/{f}"] for f in I.FIELDS])


@pytest.fixture(scope="module")
def inputs(reference):
    """The port's side of the reference's two runs, and its plain
    results."""
    cam = _camera()
    cfg = TRenderConfig(impl="torch_chunked", **I.STREAM_CFG)
    poses = torch.from_numpy(reference.inputs["poses"])
    args = dict(poses=poses,
                counts=torch.tensor(I.COUNTS, dtype=torch.int32),
                phases=tengine.stream_phases(I.B, cfg.window, device=CPU),
                carries=tengine.init_stream_carries(cam, poses))
    single = _scene(reference, "single")
    reg = tserve.SceneRegistry(I.MULTI_BUCKETS, device=CPU)
    ids = [reg.register(_scene(reference, f"multi{i}")).scene_id
           for i in range(4)]
    scenes = {"single": (single,),
              "multi": (reg.stack(ids, I.B),
                        torch.tensor(I.SLOT_SCENE, dtype=torch.int32))}

    def render(mode, mesh):
        fn = tserve.build_render_fn(cam, cfg, mesh,
                                    multi_scene=mode == "multi")
        if mode == "single":
            return fn(scenes["single"][0], **args)
        stack, slot_scene = scenes["multi"]
        return fn(stack, slot_scene=slot_scene, **args)

    plain = {mode: render(mode, None) for mode in MODES}
    return render, plain


def _assert_split(got, want):
    """The split against the plain path: frames and float carries within
    SPLIT_ATOL, every record field, frame_active and the carries' steps,
    poses and masks exactly."""
    P.assert_close(got.frames, want.frames, atol=SPLIT_ATOL)
    for name in want.records.stacked._fields:
        w = getattr(want.records.stacked, name)
        g = getattr(got.records.stacked, name)
        assert (g is None) == (w is None), name
        if w is not None:
            P.assert_equal(g, w, err_msg=name)
    for name in ("frame_active", "counts", "phases"):
        P.assert_equal(getattr(got, name), getattr(want, name), err_msg=name)
    P.assert_equal(got.carries.step, want.carries.step)
    P.assert_equal(got.carries.prev_pose, want.carries.prev_pose)
    for name in want.carries.state._fields:
        w = getattr(want.carries.state, name)
        g = getattr(got.carries.state, name)
        assert (g is None) == (w is None), name
        if w is not None:
            P.assert_close(g, w, atol=SPLIT_ATOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [2, 4, 8])
def test_split_equals_the_plain_path(inputs, mode, d):
    render, plain = inputs
    mesh = tserve.stream_mesh(I.B, (CPU,) * d)
    assert mesh == (torch.device(CPU),) * d
    got = render(mode, mesh)
    print(mode, d, "max |frames - plain|",
          float((got.frames - plain[mode].frames).abs().max()))
    _assert_split(got, plain[mode])


def test_split_runs_distinct_devices_concurrently(inputs, monkeypatch):
    """Four distinct devices: each group renders on a host thread of its
    own, and the result is the plain path's."""
    render, plain = inputs
    threads = set()
    scan = tengine.stream_scan

    def recording_scan(*a, **k):
        threads.add(threading.get_ident())
        return scan(*a, **k)

    monkeypatch.setattr(tengine, "stream_scan", recording_scan)
    mesh = tuple(torch.device(CPU, i) for i in range(4))
    got = render("multi", mesh)
    assert len(threads) == 4 and threading.get_ident() not in threads
    _assert_split(got, plain["multi"])


def test_a_failing_group_raises(inputs, monkeypatch):
    """No fallback: a group that fails fails the call."""
    render, _ = inputs

    def broken(*a, **k):
        raise RuntimeError("group failed")

    monkeypatch.setattr(tengine, "render_streams", broken)
    with pytest.raises(RuntimeError, match="group failed"):
        render("single", (CPU,) * 4)
    with pytest.raises(ValueError, match="do not split"):
        render("single", (CPU,) * 3)


def test_launch_counts_under_threads():
    """A registry counter's ``inc`` from more threads than cores, with the
    switch interval shortened: no count is lost."""
    launches = MetricsRegistry().counter("kernel_launches_total",
                                         kernel="probe")
    n_threads, each = 4 * (os.cpu_count() or 1), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            launches.inc() for _ in range(each)])
            for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert launches.value == n_threads * each


def _assert_reference(got, ref, prefix):
    P.assert_close(got.frames, ref[f"{prefix}/frames"], atol=TRAJ_ATOL)
    P.assert_equal(got.frame_active, ref[f"{prefix}/frame_active"])
    for name in got.records.stacked._fields:
        g = getattr(got.records.stacked, name)
        key = f"{prefix}/rec/{name}"
        assert (g is None) == (key not in ref), name
        if g is None:
            continue
        if name == "lane_contrib":
            P.assert_close(g, ref[key], rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            P.assert_equal(g, ref[key], err_msg=name)
    P.assert_equal(got.carries.step, ref[f"{prefix}/carry/step"])
    P.assert_equal(got.carries.prev_pose, ref[f"{prefix}/carry/prev_pose"])
    for name in got.carries.state._fields:
        g = getattr(got.carries.state, name)
        key = f"{prefix}/carry/state/{name}"
        assert (g is None) == (key not in ref), name
        if g is None:
            continue
        if g.dtype in (torch.bool, torch.int32):
            P.assert_equal(g, ref[key], err_msg=name)
        else:
            P.assert_close(g, ref[key], atol=TRAJ_ATOL, rtol=1e-6,
                           err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_split_equals_the_reference(inputs, reference, mode):
    render, _ = inputs
    got = render(mode, tserve.stream_mesh(I.B, (CPU,) * 8))
    _assert_reference(got, reference.get(), mode)


def test_stream_mesh_matches_reference(reference):
    want = json.loads(str(reference.get()["stream_mesh"]))
    got = {f"{s}|{n}": None if (m := tserve.stream_mesh(s, (CPU,) * n))
           is None else len(m)
           for n in range(1, 9) for s in range(1, 13)}
    assert got == want


# --- the server: 8 slots over 4 devices on a replayed trace ---------------

def _serve(reference, scfg, devices):
    builds = []
    reg = tserve.SceneRegistry(I.SERVE_SCFG["scene_buckets"], device=CPU)
    reg.register(_scene(reference, "multi0"))
    reg.register(_scene(reference, "multi1"))
    srv = tserve.StreamServer(reg, _camera(),
                              TRenderConfig(impl="cuda", **I.SERVE_CFG),
                              tserve.ServeConfig(**scfg), device=CPU,
                              devices=devices)
    for bat in [srv.batcher_for(b) for b in reg.buckets_in_use()]:
        build = bat.build

        def recording_build(manager, bat=bat, build=build):
            batch = build(manager)
            builds.append([bat.slots, list(batch.sids),
                           batch.slot_scene.tolist()])
            return batch

        bat.build = recording_build
    sessions = []
    attach = srv.try_attach

    def recording_attach(*a, **k):
        sess = attach(*a, **k)
        sessions.append(sess)
        return sess

    srv.try_attach = recording_attach
    report = srv.run(tserve.ReplayTraffic(
        I.SERVE_TRACE, tserve.TrafficConfig(**I.SERVE_TRAFFIC)),
        max_rounds=60)
    return report, builds, sessions


@pytest.fixture(scope="module")
def served(reference):
    return _serve(reference, I.SERVE_SCFG, (CPU,) * I.SERVE_DEVICES)


def _round_view(info):
    return {k: v for k, v in info.items() if k != "render_seconds"}


def test_server_matches_reference(served, reference):
    report, builds, _ = served
    ref = reference.get()
    want = json.loads(str(ref["server/report"]))
    assert report["num_devices"] == want["num_devices"] == I.SERVE_DEVICES
    assert report["streams_finished"] == want["streams_finished"] == 7
    assert report["slots_history"] == want["slots_history"]
    assert json.loads(json.dumps(
        [_round_view(r) for r in report["rounds_trace"]])) == \
        [_round_view(r) for r in want["rounds_trace"]]
    assert builds == json.loads(str(ref["server/builds"]))
    # B / D = 2: the batcher packs same-scene streams into slot pairs
    assert any(len({scene for sid, scene in zip(sids[i:i + 2],
                                                 slot_scene[i:i + 2])
                    if sid is not None}) == 1 and None not in sids[i:i + 2]
               for _, sids, slot_scene in builds for i in (0, 2, 4, 6))


def test_server_session_frames_match_reference(served, reference):
    _, _, sessions = served
    ref = reference.get()
    want = json.loads(str(ref["server/sessions"]))
    assert [[s.sid, s.phase, s.scene_id, s.frames_rendered]
            for s in sessions] == want
    for s in sessions:
        P.assert_close(torch.cat(s.frames), ref[f"server/frames/{s.sid}"],
                       atol=TRAJ_ATOL)


def test_server_without_sharding_uses_one_device(served, reference):
    report, _, sessions = _serve(reference,
                                 dict(I.SERVE_SCFG, use_sharding=False),
                                 (CPU,) * I.SERVE_DEVICES)
    assert report["num_devices"] == 1
    assert report["streams_finished"] == 7
    _, _, split_sessions = served
    for s, t in zip(sessions, split_sessions):
        assert s.sid == t.sid
        assert torch.equal(torch.cat(s.frames), torch.cat(t.frames))
