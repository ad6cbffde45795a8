"""Port parity: DPES (``core/dpes.py``), the brute-force oracle
(``raster.render_oracle``) and the PWSR baseline
(``warp.pixel_warp_fill``) against the JAX reference (CPU).

DPES counts are integers and agree exactly. The oracle blends 600
Gaussians one after another per pixel in float32, so the port's and the
reference's agree to atol 1e-5 (``exp`` may differ by an ulp between the
frameworks); the port's tiled render equals its own oracle to the
reference's 3e-5 (tests/test_render_system.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import dpes as jdpes
from repro.core import intersect as jint
from repro.core import pipeline as jpipe
from repro.core import projection as jproj
from repro.core import raster as jraster
from repro.core import warp as jwarp
from repro.scenes.trajectory import dolly_trajectory
from repro_torch.core import binning as tbin
from repro_torch.core import dpes as tdpes
from repro_torch.core import intersect as tint
from repro_torch.core import raster as traster
from repro_torch.core import warp as twarp
from repro_torch.core.projection import preprocess as tpreprocess


def _random_case(seed, n=300, t=40):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(n, t)) < 0.3
    depth = rng.uniform(0.1, 20.0, size=n).astype(np.float32)
    limit = rng.uniform(0.1, 20.0, size=t).astype(np.float32)
    limit[rng.uniform(size=t) < 0.25] = np.inf        # no prior
    depth[:5] = limit[:5]                             # ties at the limit
    return mask, depth, limit


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("margin", [1.0, 1.5, 0.5])
def test_dpes_random(seed, margin):
    mask, depth, limit = _random_case(seed)
    want = jdpes.predict_workload(jnp.asarray(mask), jnp.asarray(depth),
                                  jnp.asarray(limit), margin=margin)
    got = tdpes.predict_workload(torch.from_numpy(mask),
                                 torch.from_numpy(depth),
                                 torch.from_numpy(limit), margin=margin)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        P.assert_equal(g, w)
    P.assert_equal(
        tdpes.apply_depth_limit(torch.from_numpy(mask),
                                torch.from_numpy(depth),
                                torch.from_numpy(limit), margin=margin),
        jdpes.apply_depth_limit(jnp.asarray(mask), jnp.asarray(depth),
                                jnp.asarray(limit), margin=margin))
    assert bool((got.culled >= 0).all())
    assert torch.equal(got.raw - got.culled, got.predicted)


@pytest.fixture(scope="module")
def warped(small_scene, small_cam):
    """The reference's warp of a key frame to the next dolly pose, and
    the projected scene and intersection mask at that pose."""
    cfg = jpipe.RenderConfig(capacity=128, chunk=32, impl="jnp_chunked")
    poses = dolly_trajectory(3, start=(0.0, -0.3, -2.0),
                             target=(0.0, 0.0, 6.0))
    ref_cam = small_cam.with_pose(poses[0])
    tgt_cam = small_cam.with_pose(poses[2])
    fn = jax.jit(functools.partial(jpipe.render_full_frame, cfg=cfg))
    out, state, _ = fn(small_scene, ref_cam)
    w = jwarp.viewpoint_transform(state.rgb, state.exp_depth,
                                  state.trunc_depth, state.source_mask,
                                  ref_cam, tgt_cam)
    proj = jproj.preprocess(small_scene, tgt_cam)
    mask = jint.intersect(proj, jint.make_tile_grid(tgt_cam), "tait")
    return w, proj, mask, tgt_cam


def test_dpes_on_a_warped_frame(warped):
    """Warp-predicted early-stop depths over the real intersection mask."""
    w, proj, mask, _ = warped
    want = jdpes.predict_workload(mask, proj.depth, w.dpes_depth)
    got = tdpes.predict_workload(P.tensor(mask), P.tensor(proj.depth),
                                 P.tensor(w.dpes_depth))
    for g, wnt in zip(got, want):
        P.assert_equal(g, wnt)
    assert int(got.culled.sum()) > 0, "the fixture should cull some pairs"


def _warp_result(jw):
    return twarp.WarpResult(*(P.tensor(x) for x in jw))


def test_pixel_warp_fill(warped, small_scene):
    w, _, _, tgt_cam = warped
    full = jraster.render_oracle(jproj.preprocess(small_scene, tgt_cam),
                                 tgt_cam).rgb
    want = jwarp.pixel_warp_fill(w, full)
    got = twarp.pixel_warp_fill(_warp_result(w), P.tensor(full))
    P.assert_equal(got, want)
    filled = np.asarray(w.filled)
    assert 0 < filled.mean() < 1, "the fixture should have holes"
    P.assert_equal(P.np_(got)[filled], np.asarray(w.rgb)[filled])
    P.assert_equal(P.np_(got)[~filled], np.asarray(full)[~filled])


@pytest.fixture(scope="module")
def oracles(small_scene, small_cam):
    jp = jproj.preprocess(small_scene, small_cam)
    want = jraster.render_oracle(jp, small_cam)
    got = traster.render_oracle(P.projected(jp), P.camera(small_cam))
    return jp, want, got


@pytest.mark.parametrize("field", ["rgb", "transmittance", "exp_depth",
                                   "trunc_depth"])
def test_render_oracle_matches_reference(oracles, field):
    _, want, got = oracles
    P.assert_close(getattr(got, field), getattr(want, field), atol=1e-5,
                   err_msg=field)


def test_render_oracle_bookkeeping(oracles, small_cam):
    jp, want, got = oracles
    for field in ("processed_pairs", "lane_contrib", "gauss_contrib"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape and g.dtype == P.tensor(w).dtype
        assert not bool(g.any()), field
    rgb = P.np_(got.rgb)
    assert rgb.shape == (small_cam.height, small_cam.width, 3)
    assert np.isfinite(rgb).all() and rgb.max() > 0.0


@pytest.mark.parametrize("method", ["aabb", "tait", "exact"])
def test_tiled_render_matches_port_oracle(small_scene, small_cam, method):
    """The port's tiled pipeline reproduces its own oracle (the reference
    suite's identity, tests/test_render_system.py)."""
    cam = P.camera(small_cam)
    proj = tpreprocess(P.scene(small_scene), cam)
    grid = tint.make_tile_grid(cam)
    mask = tint.intersect(proj, grid, method)
    bins = tbin.build_tile_bins(mask, proj.depth, 256)
    assert int(bins.overflow.sum()) == 0, "test needs capacity headroom"
    out = traster.render_from_bins(proj, bins, grid, impl="torch_chunked")
    oracle = traster.render_oracle(proj, cam)
    P.assert_close(out.rgb, oracle.rgb, atol=3e-5)
    P.assert_close(out.transmittance, oracle.transmittance, atol=3e-5)
