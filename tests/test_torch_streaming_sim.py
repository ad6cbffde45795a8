"""Port parity: the accelerator model (``core/streaming.py``) with every
host policy of the paper's ablation and with ``policy="recorded"``,
against the reference's. Both are numpy on the host, so the timings and
the throughput summaries agree exactly, on synthetic ablation frames and
on the reference renderer's records converted through numpy. The
reference's invariants (tests/test_streaming_sim.py) are held on the
port's side too."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import streaming as jsim
from repro.core.engine import render_trajectory as jrender_trajectory
from repro.core.pipeline import RenderConfig as JRenderConfig
from repro.scenes.trajectory import dolly_trajectory
from repro_torch.core import pipeline as tpipe
from repro_torch.core import streaming as tsim

# The ablation ladder of benchmarks/accelerator.py:36-47 (its MODES).
MODES = {
    "gpu_like": dict(policy="dynamic", workload_source="raw",
                     light_to_heavy=False, streaming=False),
    "gscore_like": dict(policy="round_robin", workload_source="raw",
                        light_to_heavy=False, streaming=True),
    "ld1": dict(policy="ls_gaussian", workload_source="dpes",
                light_to_heavy=False, streaming=True),
    "ls_gaussian": dict(policy="ls_gaussian", workload_source="dpes",
                        light_to_heavy=True, streaming=True),
    "static_blocked": dict(policy="static_blocked", workload_source="dpes",
                           light_to_heavy=True, streaming=True),
}


def _ablation_frames(seed, n_frames=6, t=256, heavy_frac=0.08,
                     sparse_every=0):
    """Fig. 5-style order-of-magnitude tile-load spread (as the
    reference's suite builds it); optionally every ``sparse_every``-th
    frame is TWSR-sparse. Returns (kwargs per frame) for either
    package's FrameWork."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        w = rng.integers(20, 80, size=t).astype(np.int64)
        heavy = rng.choice(t, int(t * heavy_frac), replace=False)
        w[heavy] = rng.integers(300, 700, size=len(heavy))
        active = np.ones(t, bool)
        warp_px = 0
        if sparse_every and f % sparse_every != 0:
            active = rng.random(t) < 0.3
            w = np.where(active, w, 0)
            warp_px = t * 256
        frames.append(dict(
            n_gaussians=2000, candidate_pairs=int(w.sum() * 1.2),
            raw_pairs=w * 2, sort_pairs=w, raster_pairs=w, active=active,
            n_warp_pixels=warp_px, tiles_x=16, tiles_y=16))
    return frames


def _both(frames_kw):
    return ([jsim.FrameWork(**kw) for kw in frames_kw],
            [tsim.FrameWork(**kw) for kw in frames_kw])


def _assert_same_run(jframes, tframes, cfg_kw, **kw):
    jt = jsim.simulate_sequence(jframes, jsim.AcceleratorConfig(**cfg_kw),
                                **kw)
    tt = tsim.simulate_sequence(tframes, tsim.AcceleratorConfig(**cfg_kw),
                                **kw)
    assert [dataclasses.asdict(t) for t in tt] == \
        [dataclasses.asdict(t) for t in jt]
    b = cfg_kw.get("num_blocks", 32)
    assert tsim.throughput(tt, b) == jsim.throughput(jt, b)
    assert tsim.throughput(tt) == jsim.throughput(jt)
    return tt


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("sparse_every", [0, 3])
@pytest.mark.parametrize("blocks", [8, 32, 33])
def test_modes_equal_reference(mode, sparse_every, blocks):
    jf, tf = _both(_ablation_frames(7, sparse_every=sparse_every))
    for streaming in (True, False):
        kw = dict(MODES[mode], streaming=streaming)
        _assert_same_run(jf, tf, dict(num_blocks=blocks), **kw)
    kw = dict(MODES[mode], light_to_heavy=not MODES[mode]["light_to_heavy"])
    _assert_same_run(jf, tf, dict(num_blocks=blocks, gsu_rate=4.0), **kw)


@pytest.fixture(scope="module")
def reference_records(small_scene, small_cam):
    poses = dolly_trajectory(4, start=(0.0, -0.3, -2.0),
                             target=(0.0, 0.0, 6.0))
    res = jrender_trajectory(small_scene, small_cam, poses,
                             JRenderConfig(window=2, ldu_blocks=8))
    return res.records, small_cam


def _port_frames(jrecords, cam):
    """The reference's stacked records as the port's, through numpy."""
    stacked = tpipe.FrameRecord(*(
        None if v is None else torch.tensor(np.asarray(v))
        for v in jrecords.stacked))
    return tsim.frameworks_from_stacked(
        tpipe.StackedRecords(stacked), cam.tiles_x, cam.tiles_y,
        cam.width * cam.height)


@pytest.mark.parametrize("mode", sorted(MODES) + ["recorded"])
def test_real_records_equal_reference(reference_records, mode):
    jrecords, cam = reference_records
    jf = jsim.frameworks_from_stacked(jrecords, cam.tiles_x, cam.tiles_y,
                                      cam.width * cam.height)
    tf = _port_frames(jrecords, cam)
    assert len(tf) == len(jf) == 4
    for a, b in zip(tf, jf):
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), f.name)
    kw = dict(policy="recorded") if mode == "recorded" else MODES[mode]
    _assert_same_run(jf, tf, dict(num_blocks=8), **kw)


def test_recorded_equals_host_ls_gaussian(reference_records):
    """The reference's device LDU equals its numpy golden on these
    frames, so replaying the record and re-deriving "ls_gaussian" on the
    host give one timeline in the port."""
    jrecords, cam = reference_records
    tf = _port_frames(jrecords, cam)
    cfg = tsim.AcceleratorConfig(num_blocks=8)
    rec = tsim.simulate_sequence(tf, cfg, policy="recorded")
    host = tsim.simulate_sequence(tf, cfg, policy="ls_gaussian")
    assert rec == host


def test_default_policy_is_recorded(reference_records):
    """Both packages called with no policy give one timeline: the port's
    default is the reference's (``ls_gaussian``, the host golden), no
    longer ``recorded`` as the test's name still says."""
    jrecords, cam = reference_records
    jf = jsim.frameworks_from_stacked(jrecords, cam.tiles_x, cam.tiles_y,
                                      cam.width * cam.height)
    tf = _port_frames(jrecords, cam)
    _assert_same_run(jf, tf, dict(num_blocks=8))
    cfg = tsim.AcceleratorConfig(num_blocks=8)
    assert tsim.simulate_sequence(tf, cfg) == \
        tsim.simulate_sequence(tf, cfg, policy="ls_gaussian")
    with pytest.raises(ValueError, match="built for 8 blocks"):
        tsim.simulate_sequence(tf, tsim.AcceleratorConfig(num_blocks=4),
                               policy="recorded")
    with pytest.raises(ValueError, match="unknown policy"):
        tsim.simulate_sequence(tf, cfg, policy="x")


# The reference's invariants, on the port's simulator.

def _wall_span(timings):
    return max(t.frame_end for t in timings)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("sparse_every", [0, 3])
def test_streaming_never_slower(mode, sparse_every):
    _, frames = _both(_ablation_frames(7, sparse_every=sparse_every))
    cfg = tsim.AcceleratorConfig(num_blocks=32)
    kw = {k: v for k, v in MODES[mode].items() if k != "streaming"}
    stream = tsim.simulate_sequence(frames, cfg, streaming=True, **kw)
    barrier = tsim.simulate_sequence(frames, cfg, streaming=False, **kw)
    assert _wall_span(stream) <= _wall_span(barrier) + 1e-6, mode


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("streaming", [True, False])
def test_utilization_bounds(mode, streaming):
    _, frames = _both(_ablation_frames(11, sparse_every=3))
    cfg = tsim.AcceleratorConfig(num_blocks=32)
    kw = {k: v for k, v in MODES[mode].items() if k != "streaming"}
    timings = tsim.simulate_sequence(frames, cfg, streaming=streaming, **kw)
    t = tsim.throughput(timings, cfg.num_blocks)
    assert 0.0 < t["utilization"] <= 1.0 + 1e-9, (mode, t["utilization"])
    for ft in timings:
        assert 0.0 < ft.utilization <= 1.0 + 1e-9
        assert ft.frame_end >= ft.prep_end


@pytest.mark.parametrize("seed", [3, 13, 23])
@pytest.mark.parametrize("gsu_rate", [2.0, 8.0, 64.0])
def test_light_to_heavy_never_increases_sort_stall(seed, gsu_rate):
    _, frames = _both(_ablation_frames(seed))
    cfg = tsim.AcceleratorConfig(num_blocks=32, gsu_rate=gsu_rate)
    with_ld2 = tsim.throughput(tsim.simulate_sequence(
        frames, cfg, policy="ls_gaussian", workload_source="dpes",
        light_to_heavy=True), cfg.num_blocks)
    without = tsim.throughput(tsim.simulate_sequence(
        frames, cfg, policy="ls_gaussian", workload_source="dpes",
        light_to_heavy=False), cfg.num_blocks)
    assert with_ld2["sort_stall"] <= without["sort_stall"] + 1e-6


def test_ls_schedule_beats_baseline_utilization():
    """Tab. I's claim on the port's simulator: balanced distribution
    lifts utilization over the GSCore-like baseline."""
    _, frames = _both(_ablation_frames(7))
    cfg = tsim.AcceleratorConfig(num_blocks=32)
    base = tsim.throughput(tsim.simulate_sequence(
        frames, cfg, policy="round_robin", workload_source="raw",
        light_to_heavy=False, streaming=False), cfg.num_blocks)
    ls = tsim.throughput(tsim.simulate_sequence(
        frames, cfg, policy="ls_gaussian"), cfg.num_blocks)
    assert ls["utilization"] > base["utilization"] + 0.1
    assert ls["cycles_per_frame"] < base["cycles_per_frame"]
