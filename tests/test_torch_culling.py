"""Port parity for contribution culling (core/culling.py) against the
JAX reference on the CPU: ``warp_gate`` and ``cull_pairs`` exactly on
seeded inputs, and a culled trajectory through both engines with every
FrameRecord field exact (``culled_pairs`` included) and frames within
1e-4 (the warp chains frames)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import culling as jcull
from repro.core import engine as jengine
from repro.core import pipeline as jpipe
from repro.scenes.trajectory import dolly_trajectory
from repro_torch.core import culling as tcull
from repro_torch.core import engine as tengine
from repro_torch.core import pipeline as tpipe

TRAJ_ATOL = 1e-4
THRESHOLD = 0.05


def test_warp_gate_matches_reference():
    counts = np.random.default_rng(0).integers(0, 3, size=64, dtype=np.int32)
    P.assert_equal(tcull.warp_gate(torch.from_numpy(counts)),
                   jcull.warp_gate(jnp.asarray(counts)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_pairs_matches_reference(seed):
    """Random (N, R) masks, priors with inf (never considered) and
    values on both sides of the threshold, a partial gate and inactive
    slots: mask, demoted flags and the culled count agree exactly."""
    rng = np.random.default_rng(seed)
    n, r, t = 40, 12, 20
    mask = rng.uniform(size=(n, r)) < 0.3
    slot_active = rng.uniform(size=r) < 0.8
    mask &= slot_active[None, :]
    tile_ids = rng.permutation(t)[:r].astype(np.int32)
    prior = rng.uniform(0.0, 2 * THRESHOLD, size=n).astype(np.float32)
    prior[rng.uniform(size=n) < 0.2] = np.inf
    gate = rng.uniform(size=t) < 0.7
    want = jcull.cull_pairs(jnp.asarray(mask), jnp.asarray(slot_active),
                            jnp.asarray(tile_ids), jnp.asarray(prior),
                            jnp.asarray(gate), THRESHOLD)
    got = tcull.cull_pairs(*(torch.from_numpy(a) for a in
                             (mask, slot_active, tile_ids, prior, gate)),
                           THRESHOLD)
    for g, w in zip(got, want):
        P.assert_equal(g, w)
    assert got[2].dtype == torch.int32 and int(got[2]) > 0


def test_cull_pairs_demotes_only_fully_culled_slots():
    """The reference suite's hand-built case: inf priors are kept,
    ungated slots untouched, a slot losing all its pairs is demoted, an
    empty slot is not."""
    prior = torch.tensor([float("inf"), 0.0, 1.0, 0.2])
    active = torch.ones(3, dtype=torch.bool)
    tile_ids = torch.arange(3, dtype=torch.int32)
    gate = torch.tensor([True, True, False])
    mask = torch.zeros((4, 3), dtype=torch.bool)
    mask[3, 1] = True
    new_mask, new_active, culled = tcull.cull_pairs(mask, active, tile_ids,
                                                    prior, gate, 0.5)
    assert not bool(new_mask.any()) and int(culled) == 1
    assert new_active.tolist() == [True, False, True]


@pytest.mark.parametrize("impl", ["torch_chunked", "cuda_fused", "cuda"])
def test_culled_trajectory_matches_reference(small_scene, small_cam, impl):
    """6 frames, window 3, threshold 0.05: the port's engine against the
    reference's scanned engine. Culling removes pairs on sparse frames
    only, and the priors sit far enough from the threshold that no pair
    flips on rounding."""
    base = dict(capacity=128, chunk=32, window=3, cull_threshold=THRESHOLD)
    jcfg = jpipe.RenderConfig(impl="jnp_chunked", **base)
    tcfg = tpipe.RenderConfig(impl=impl, **base)
    poses = dolly_trajectory(6, start=(0.0, -0.3, -2.0),
                             target=(0.0, 0.0, 6.0))
    want = jengine.render_trajectory(small_scene, small_cam, poses, jcfg,
                                     keep_states=True)
    got = tengine.render_trajectory(P.scene(small_scene),
                                    P.camera(small_cam), P.tensor(poses),
                                    tcfg, keep_states=True)
    prior = np.asarray(want.states.contrib)
    fin = np.isfinite(prior)
    assert np.abs(prior[fin] - THRESHOLD).min() > 1e-4 * THRESHOLD
    P.assert_close(got.frames, want.frames, atol=TRAJ_ATOL)
    P.assert_records(got.records.stacked, want.records.stacked)
    culled = P.np_(got.records.culled_pairs)
    is_full = P.np_(got.records.is_full)
    assert (culled[is_full] == 0).all() and culled[~is_full].sum() > 0


def test_threshold_zero_leaves_the_pass_out(small_scene, small_cam):
    """cull_threshold 0 with record_contrib renders bit-identically to
    the plain config (the prior is threaded but never applied)."""
    base = tpipe.RenderConfig(capacity=128, chunk=32, window=3,
                              impl="torch_chunked")
    poses = P.tensor(dolly_trajectory(3, start=(0.0, -0.3, -2.0),
                                      target=(0.0, 0.0, 6.0)))
    scene, cam = P.scene(small_scene), P.camera(small_cam)
    a = tengine.render_trajectory(scene, cam, poses, base)
    b = tengine.render_trajectory(
        scene, cam, poses, dataclasses.replace(base, record_contrib=True))
    P.assert_equal(a.frames, b.frames)
    assert int(b.records.culled_pairs.sum()) == 0
