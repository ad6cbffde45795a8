"""Port parity for the multi-stream engine (``render_streams``) against
the JAX reference on the CPU: B = 3 streams of F = 4 frames with ragged
counts and staggered phases, a resume across two chunks from the
returned carries, and the ``slot_scene`` path over two scenes. Frames
agree within 1e-4 (the warp chains frames), every FrameRecord field and
carry step exactly. Port against port, active frames equal a solo run
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import engine as jengine
from repro.core import pipeline as jpipe
from repro.scenes.synthetic import structured_scene
from repro.scenes.trajectory import dolly_trajectory
from repro.serve.scenes import pad_scene as jpad_scene
from repro_torch.core import engine as tengine
from repro_torch.core import pipeline as tpipe

TRAJ_ATOL = 1e-4
COUNTS = (4, 2, 0)
PHASES = (0, 1, 2)
CFG = dict(capacity=128, chunk=32, window=3, rerender_capacity=8)


def _cfgs():
    return (jpipe.RenderConfig(impl="jnp_chunked", **CFG),
            tpipe.RenderConfig(impl="torch_chunked", **CFG))


def _poses_batch(b, f):
    return np.stack([np.asarray(dolly_trajectory(
        f, start=(0.04 * i, -0.3, -2.0), target=(0.0, 0.0, 6.0)))
        for i in range(b)])


def _assert_streams(got, want):
    P.assert_close(got.frames, want.frames, atol=TRAJ_ATOL)
    P.assert_records(got.records.stacked, want.records.stacked)
    P.assert_equal(got.frame_active, want.frame_active)
    P.assert_equal(got.counts, want.counts)
    P.assert_equal(got.phases, want.phases)
    P.assert_equal(got.carries.step, want.carries.step)
    P.assert_equal(got.carries.prev_pose, want.carries.prev_pose)
    P.assert_equal(got.carries.state.source_mask,
                   want.carries.state.source_mask)
    P.assert_equal(got.carries.state.frame_idx, want.carries.state.frame_idx)
    for name in ("rgb", "exp_depth", "trunc_depth"):
        P.assert_close(getattr(got.carries.state, name),
                       getattr(want.carries.state, name), atol=TRAJ_ATOL,
                       rtol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def ragged(small_scene, small_cam):
    jcfg, tcfg = _cfgs()
    poses = _poses_batch(3, 4)
    want = jengine.render_streams(small_scene, small_cam, jnp.asarray(poses),
                                  jcfg, phases=PHASES, counts=COUNTS)
    got = tengine.render_streams(P.scene(small_scene), P.camera(small_cam),
                                 P.tensor(poses), tcfg, phases=PHASES,
                                 counts=COUNTS)
    return got, want, poses


def test_render_streams_matches_reference(ragged):
    got, want, _ = ragged
    _assert_streams(got, want)
    assert got.frame_active.tolist() == [[k < c for k in range(4)]
                                         for c in COUNTS]
    # Frames past a count are not rendered: zeros, blanked records, and
    # the idle stream's carry still at step 0.
    assert not bool(got.frames[1, 2:].any() or got.frames[2].any())
    assert not bool(got.records.active[2].any())
    assert (P.np_(got.records.block_of_tile[2]) == -1).all()
    assert got.carries.step.tolist() == [4, 2, 0]


def test_active_frames_equal_solo_runs(ragged, small_scene, small_cam):
    """Port against port: every active prefix is bit-identical to a solo
    ``render_trajectory`` at the stream's phase."""
    got, _, poses = ragged
    _, tcfg = _cfgs()
    for i, c in enumerate(COUNTS):
        if not c:
            continue
        solo = tengine.render_trajectory(
            P.scene(small_scene), P.camera(small_cam), P.tensor(poses[i, :c]),
            tcfg, phase=PHASES[i])
        assert torch.equal(got.frames[i, :c], solo.frames)
        for name in solo.records.stacked._fields:
            w = getattr(solo.records, name)
            if w is not None:
                assert torch.equal(getattr(got.records, name)[i, :c], w), name


def test_resume_across_chunks_matches_reference(small_scene, small_cam):
    """A 7-frame trajectory served as two chunks of 4 (the second one
    ragged) from the returned carries equals the reference's one-shot
    solo trajectories: the key-frame schedule survives the seam."""
    jcfg, tcfg = _cfgs()
    b, chunk, total = 2, 4, 7
    phases = (1, 2)
    full = _poses_batch(b, total)
    scene, cam = P.scene(small_scene), P.camera(small_cam)
    carries = tengine.init_stream_carries(cam, P.tensor(full))
    frames, recs = [], []
    for start in range(0, total, chunk):
        n = min(chunk, total - start)
        sl = full[:, start:start + n]
        pad = np.concatenate([sl, np.repeat(sl[:, -1:], chunk - n, axis=1)],
                             axis=1)
        res = tengine.render_streams(scene, cam, P.tensor(pad), tcfg,
                                     phases=phases, counts=(n,) * b,
                                     carries=carries)
        carries = res.carries
        frames.append(res.frames[:, :n])
        recs.append(res.records.stacked)
    assert carries.step.tolist() == [total] * b
    for i in range(b):
        want = jengine.render_trajectory(small_scene, small_cam,
                                         jnp.asarray(full[i]), jcfg,
                                         phase=phases[i])
        P.assert_close(torch.cat([f[i] for f in frames]), want.frames,
                       atol=TRAJ_ATOL)
        for name in want.records.stacked._fields:
            w = getattr(want.records, name)
            if w is None:
                continue
            g = torch.cat([getattr(r, name)[i, :min(chunk, total - s)]
                           for r, s in zip(recs, range(0, total, chunk))])
            P.assert_equal(g, w, err_msg=name)


def test_slot_scene_two_scenes_matches_reference(small_cam):
    """Two scenes padded to one bucket; streams pick theirs by
    ``slot_scene`` (the port indexes a list, the reference gathers from
    a stacked pytree)."""
    jscenes = [jpad_scene(structured_scene(jax.random.PRNGKey(100 + i),
                                           260 + 30 * i, clutter=0.3 + 0.1 * i),
                          512) for i in range(2)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jscenes)
    jcfg, tcfg = _cfgs()
    slot_scene = (1, 0, 1)
    counts = (3, 2, 1)
    poses = _poses_batch(3, 3)
    want = jengine.render_streams(stacked, small_cam, jnp.asarray(poses),
                                  jcfg, phases=PHASES, counts=counts,
                                  slot_scene=slot_scene)
    got = tengine.render_streams([P.scene(s) for s in jscenes],
                                 P.camera(small_cam), P.tensor(poses), tcfg,
                                 phases=PHASES, counts=counts,
                                 slot_scene=slot_scene)
    _assert_streams(got, want)


def test_stream_phases_and_blank_record(small_cam):
    assert tengine.stream_phases(4, 5, device="cpu").tolist() == \
        np.asarray(jengine.stream_phases(4, 5)).tolist()
    assert tengine.stream_phases(7, 3, device="cpu").tolist() == \
        np.asarray(jengine.stream_phases(7, 3)).tolist()
    cfg = tpipe.RenderConfig(record_contrib=True, capacity=128)
    rec = tengine.blank_record(P.camera(small_cam), cfg, 600)
    assert tuple(rec.lane_contrib.shape) == (small_cam.num_tiles, 128)
    assert rec.block_load.shape == (cfg.ldu_blocks,)
