"""Port parity: TWSR warp (viewpoint transform, z-buffer, inpaint) against
the JAX reference, from the same reference-frame state (CPU)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import pipeline as jpipe
from repro.core import warp as jwarp
from repro.scenes.trajectory import dolly_trajectory, orbit_trajectory
from repro_torch.core import warp as twarp

# Pixels whose reprojection lands one pixel over in one framework (the
# floor of a coordinate within rounding of an integer) may differ; the
# share of such target pixels is pinned.
MAX_SHIFTED_SHARE = 1e-3


@pytest.fixture(scope="module")
def ref_state(small_scene, small_cam):
    cfg = jpipe.RenderConfig(capacity=128, chunk=32, impl="jnp_chunked")
    fn = jax.jit(functools.partial(jpipe.render_full_frame, cfg=cfg))
    _, state, _ = fn(small_scene, small_cam)
    return state


def _poses(kind):
    if kind == "identity":
        return None
    if kind == "dolly":
        return dolly_trajectory(3, start=(0.0, -0.3, -2.0),
                                target=(0.0, 0.0, 6.0))[2]
    return orbit_trajectory(4, radius=8.0, target=(0.0, 0.0, 6.0))[3]


@pytest.mark.parametrize("kind", ["identity", "dolly", "orbit"])
def test_viewpoint_transform_matches(ref_state, small_cam, kind):
    pose = _poses(kind)
    tgt = small_cam if pose is None else small_cam.with_pose(pose)
    s = ref_state
    want = jwarp.viewpoint_transform(s.rgb, s.exp_depth, s.trunc_depth,
                                     s.source_mask, small_cam, tgt)
    ts = P.frame_state(s)
    got = twarp.viewpoint_transform(ts.rgb, ts.exp_depth, ts.trunc_depth,
                                    ts.source_mask, P.camera(small_cam),
                                    P.camera(tgt))
    assert got.valid_per_tile.dtype == torch.int32
    filled_diff = P.np_(got.filled) != np.asarray(want.filled)
    assert filled_diff.mean() <= MAX_SHIFTED_SHARE
    same = ~filled_diff
    P.assert_close(P.np_(got.rgb)[same], np.asarray(want.rgb)[same],
                   atol=1e-5)
    for name in ("exp_depth", "trunc_depth"):
        P.assert_close(P.np_(getattr(got, name))[same],
                       np.asarray(getattr(want, name))[same], atol=1e-4,
                       rtol=1e-5, err_msg=name)
    for name in ("valid_per_tile", "interpolate_tile", "rerender_tile"):
        P.assert_equal(getattr(got, name), getattr(want, name),
                       err_msg=name)
    P.assert_close(got.dpes_depth, want.dpes_depth, atol=1e-4, rtol=1e-5)
    if kind == "identity":
        # Every covered source maps onto itself.
        cov = np.asarray(s.source_mask)
        assert bool(np.all(P.np_(got.filled)[cov]))


def test_scatter_zbuffer_averages_ties():
    rng = np.random.default_rng(4)
    s, size = 400, 64
    ti = rng.integers(0, size, s).astype(np.int32)
    z = rng.uniform(1.0, 2.0, s).astype(np.float32)
    z[::7] = z[0]  # exact ties onto target ti[0]
    ti[::7] = ti[0]
    valid = rng.uniform(size=s) < 0.8
    vals = rng.uniform(size=(s, 4)).astype(np.float32)
    want = jwarp._scatter_zbuffer(jnp.asarray(ti), jnp.asarray(z),
                                  jnp.asarray(valid), jnp.asarray(vals),
                                  size)
    got = twarp._scatter_zbuffer(*(torch.from_numpy(a) for a in
                                   (ti, z, valid, vals)), size)
    P.assert_close(got[0], want[0], atol=0.0)
    P.assert_close(got[1], want[1], atol=1e-6)
    P.assert_equal(got[2], want[2])


@pytest.mark.parametrize("iters", [1, 8])
def test_inpaint_matches(iters):
    rng = np.random.default_rng(iters)
    img = rng.uniform(size=(32, 48, 5)).astype(np.float32)
    filled = rng.uniform(size=(32, 48)) < 0.7
    want = jwarp.inpaint(jnp.asarray(img), jnp.asarray(filled), iters=iters)
    got = twarp.inpaint(torch.from_numpy(img), torch.from_numpy(filled),
                        iters=iters)
    P.assert_close(got, want, atol=1e-6)
