"""Port parity for the slice: one key frame, one sparse frame and a
6-frame streaming trajectory against the JAX reference (CPU).

Images agree to 2e-5 per frame (the reference's fused-vs-jnp pin) and
1e-4 over a trajectory (the warp chains frames); every FrameRecord field
agrees exactly."""
import functools

import jax
import numpy as np
import pytest

import _torch_parity as P
from repro.core import engine as jengine
from repro.core import pipeline as jpipe
from repro.scenes.trajectory import dolly_trajectory
from repro_torch.core import engine as tengine
from repro_torch.core import pipeline as tpipe

ATOL = 2e-5
TRAJ_ATOL = 1e-4
IMAGE_FIELDS = ("rgb", "transmittance", "exp_depth", "trunc_depth")


def _cfgs(impl, **kw):
    base = dict(capacity=128, chunk=32, window=3)
    base.update(kw)
    return (jpipe.RenderConfig(impl="jnp_chunked", **base),
            tpipe.RenderConfig(impl=impl, **base))


def _poses(n):
    return dolly_trajectory(n, start=(0.0, -0.3, -2.0),
                            target=(0.0, 0.0, 6.0))


@pytest.fixture(scope="module")
def key_frames(small_scene, small_cam):
    jcfg, _ = _cfgs("torch_chunked")
    fn = jax.jit(functools.partial(jpipe.render_full_frame, cfg=jcfg))
    return fn(small_scene, small_cam.with_pose(_poses(2)[0]))


@pytest.mark.parametrize("impl", ["torch_chunked", "cuda_fused"])
def test_full_frame_matches_reference(small_scene, small_cam, key_frames,
                                      impl):
    _, tcfg = _cfgs(impl)
    jout, jstate, jrec = key_frames
    tcam = P.camera(small_cam.with_pose(_poses(2)[0]))
    out, state, rec = tpipe.render_full_frame(P.scene(small_scene), tcam,
                                              tcfg)
    for name in IMAGE_FIELDS:
        P.assert_close(getattr(out, name), getattr(jout, name), atol=ATOL,
                       err_msg=name)
    P.assert_equal(out.processed_pairs, jout.processed_pairs)
    P.assert_records(rec, jrec)
    P.assert_equal(state.source_mask, jstate.source_mask)
    assert int(state.frame_idx) == int(jstate.frame_idx) == 0
    assert state.contrib is None


@pytest.mark.parametrize("rcap", [None, 8, 2])
def test_sparse_frame_matches_reference(small_scene, small_cam, key_frames,
                                        rcap):
    """One TWSR frame from the same reference state: uncapped, compacted
    and overflowing plans (rcap=2 degrades tiles to interpolation)."""
    jcfg, tcfg = _cfgs("cuda_fused", rerender_capacity=rcap)
    poses = _poses(2)
    ref_cam = small_cam.with_pose(poses[0])
    tgt_cam = small_cam.with_pose(poses[1])
    _, jstate, _ = key_frames
    fn = jax.jit(functools.partial(jpipe.render_sparse_frame, cfg=jcfg))
    jrgb, jnew, jrec = fn(small_scene, ref_cam, tgt_cam, jstate)
    rgb, new, rec = tpipe.render_sparse_frame(
        P.scene(small_scene), P.camera(ref_cam), P.camera(tgt_cam),
        P.frame_state(jstate), tcfg)
    P.assert_close(rgb, jrgb, atol=ATOL)
    P.assert_records(rec, jrec)
    for name in ("rgb", "exp_depth", "trunc_depth"):
        P.assert_close(getattr(new, name), getattr(jnew, name), atol=ATOL,
                       rtol=1e-6, err_msg=name)
    P.assert_equal(new.source_mask, jnew.source_mask)
    assert int(new.frame_idx) == int(jnew.frame_idx) == 1
    assert int(rec.tiles_interpolated) > 0
    if rcap == 2:
        assert int(rec.overflow_tiles) > 0


@pytest.mark.parametrize("impl", ["torch_chunked", "cuda_fused"])
def test_trajectory_matches_reference(small_scene, small_cam, impl):
    """engine.render_trajectory over 6 frames, window 3, against the
    reference's scanned engine: records exact, frames within 1e-4."""
    jcfg, tcfg = _cfgs(impl)
    poses = _poses(6)
    want = jengine.render_trajectory(small_scene, small_cam, poses, jcfg)
    got = tengine.render_trajectory(P.scene(small_scene), P.camera(small_cam),
                                    P.tensor(poses), tcfg)
    assert tuple(got.frames.shape) == tuple(want.frames.shape)
    P.assert_close(got.frames, want.frames, atol=TRAJ_ATOL)
    assert len(got.records) == 6
    assert got.records.is_full.tolist() == [True, False, False, True,
                                            False, False]
    P.assert_records(got.records.stacked, want.records.stacked)


def test_trajectory_py_matches_engine(small_scene, small_cam):
    """The golden host loop and the engine agree exactly (same code path
    per frame), with states kept."""
    _, tcfg = _cfgs("torch_chunked", rerender_capacity=4)
    scene, cam = P.scene(small_scene), P.camera(small_cam)
    poses = P.tensor(_poses(5))
    a = tpipe.render_trajectory_py(scene, cam, poses, tcfg, keep_states=True)
    b = tpipe.render_trajectory(scene, cam, poses, tcfg, keep_states=True)
    P.assert_equal(a.frames, b.frames)
    P.assert_records(a.records.stacked, b.records.stacked)
    P.assert_equal(a.states.frame_idx, [0, 1, 2, 3, 4])
    P.assert_equal(a.states.source_mask, b.states.source_mask)
    rec2 = b.records[2]
    P.assert_equal(rec2.raster_pairs, b.records.raster_pairs[2])


@pytest.mark.parametrize("phase", [0, 2])
def test_key_frame_schedule(small_scene, small_cam, phase):
    """Frame f is a key frame iff f == 0 or (f + phase) % window == 0."""
    _, tcfg = _cfgs("torch_chunked", capacity=64, rerender_capacity=2)
    res = tengine.render_trajectory(P.scene(small_scene),
                                    P.camera(small_cam),
                                    P.tensor(_poses(5)), tcfg, phase=phase)
    want = [f == 0 or (f + phase) % 3 == 0 for f in range(5)]
    assert res.records.is_full.tolist() == want


def test_record_contrib_matches_reference(small_scene, small_cam):
    """record_contrib threads lane contributions and the key-frame prior."""
    jcfg, tcfg = _cfgs("cuda_fused", record_contrib=True)
    poses = _poses(3)
    want = jpipe.render_trajectory_py(small_scene, small_cam, poses, jcfg,
                                      keep_states=True)
    got = tpipe.render_trajectory_py(P.scene(small_scene),
                                     P.camera(small_cam), P.tensor(poses),
                                     tcfg, keep_states=True)
    P.assert_records(got.records.stacked, want.records.stacked)
    prior, jprior = P.np_(got.states.contrib), np.asarray(want.states.contrib)
    P.assert_equal(np.isinf(prior), np.isinf(jprior))
    fin = np.isfinite(jprior)
    P.assert_close(prior[fin], jprior[fin], rtol=1e-4, atol=1e-5)


def test_culling_not_ported_yet(small_scene, small_cam):
    """Culling is ported now: a nonzero threshold is accepted and culls
    pairs on a sparse frame warped from a key frame's prior
    (test_torch_culling.py holds it against the reference)."""
    _, tcfg = _cfgs("torch_chunked", cull_threshold=0.05)
    poses = _poses(2)
    scene = P.scene(small_scene)
    ref_cam = P.camera(small_cam.with_pose(poses[0]))
    _, state, rec = tpipe.render_full_frame(scene, ref_cam, tcfg)
    assert int(rec.culled_pairs) == 0 and state.contrib is not None
    _, _, rec = tpipe.render_sparse_frame(
        scene, ref_cam, P.camera(small_cam.with_pose(poses[1])), state, tcfg)
    assert int(rec.culled_pairs) > 0
