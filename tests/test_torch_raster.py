"""Port parity: the raster impls (the fused kernel's plain version, the
tile kernel's plain version, the chunked blend, the sequential oracle)
against the JAX reference's ``ref``, ``jnp_chunked``, ``pallas_fused``
and ``pallas`` (both interpret mode) on the CPU. Images agree to 2e-5 (the reference suite's fused-vs-jnp pin,
tests/test_raster_plan.py), processed pairs exactly, lane contributions
to rtol 1e-4 (sums over 256 pixels in another order)."""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import binning as jbin
from repro.core import intersect as jint
from repro.core import projection as jproj
from repro.core import raster as jraster
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import binning as tbin
from repro_torch.core import intersect as tint
from repro_torch.core import pipeline as tpipe
from repro_torch.core import projection as tproj
from repro_torch.core import raster as traster
from repro_torch.kernels import ops as tops
from repro_torch.kernels import raster_plan as trp
from repro_torch.kernels import raster_tile as trt
from repro_torch.kernels import ref as tref
from repro_torch.obs.metrics import kernel_launches

ATOL = 2e-5
CONTRIB_RTOL = 1e-4

IMPL_PAIRS = [("ref", "ref"), ("torch_chunked", "jnp_chunked"),
              ("cuda_fused", "pallas_fused"), ("cuda", "pallas")]


def _tile_inputs(scene, cam, capacity):
    proj = jproj.preprocess(scene, cam)
    grid = jint.make_tile_grid(cam)
    bins = jbin.build_tile_bins(jint.tait_mask(proj, grid), proj.depth,
                                capacity)
    tg = jbin.gather_tiles(proj, bins)
    return (tg.mean2d, tg.conic, tg.rgb, tg.opacity, tg.depth,
            grid.origins, bins.count)


def _torch_args(jargs):
    return tuple(P.tensor(a) for a in jargs)


def _assert_outputs(got, want, *, exact_processed=True):
    for g, w in zip(got[:4], want[:4]):
        P.assert_close(g, w, atol=ATOL)
    if exact_processed:
        P.assert_equal(got[4], want[4])
    P.assert_close(got[5], want[5], rtol=CONTRIB_RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def tile_inputs(small_scene, small_cam):
    return {cap: _tile_inputs(small_scene, small_cam, cap)
            for cap in (64, 96, 128)}


@pytest.mark.parametrize("capacity,chunk", [(64, 16), (96, 32), (128, 64)])
@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_impls_match_reference(tile_inputs, capacity, chunk, impl, jimpl):
    jargs = tile_inputs[capacity]
    want = jops.raster_tiles(*jargs, impl=jimpl, chunk=chunk)
    got = tops.raster_tiles(*_torch_args(jargs), impl=impl, chunk=chunk)
    assert got[4].dtype == torch.int32
    assert tuple(got[5].shape) == tuple(np.asarray(want[5]).shape)
    _assert_outputs(got, want)
    # Every port impl also holds against the sequential oracle.
    _assert_outputs(got, jops.raster_tiles(*jargs, impl="ref"),
                    exact_processed=impl == "ref")


def _shuffle(args, seed=0):
    mean2d, conic, rgb, opacity, depth, origins, counts = args
    rng = np.random.default_rng(seed)
    outs = [P.np_(a).copy() for a in (mean2d, conic, rgb, opacity, depth)]
    perms = []
    for r, c in enumerate(P.np_(counts)):
        p = rng.permutation(int(c))
        perms.append(p)
        for o in outs:
            o[r, :int(c)] = o[r, :int(c)][p]
    return tuple(torch.from_numpy(o) for o in outs) + (origins, counts), \
        perms


@pytest.mark.parametrize("capacity,chunk", [(64, 32), (96, 32)])
def test_fused_plain_sorts_shuffled_lanes(tile_inputs, capacity, chunk):
    """The fused kernel's plain version renders depth-shuffled lanes
    identically, and lane_contrib follows the input lanes."""
    args = _torch_args(tile_inputs[capacity])
    shuf, perms = _shuffle(args, seed=capacity)
    o_sorted = tops.raster_tiles(*args, impl="cuda_fused", chunk=chunk)
    o_shuf = tops.raster_tiles(*shuf, impl="cuda_fused", chunk=chunk)
    for a, b in zip(o_shuf[:5], o_sorted[:5]):
        P.assert_equal(a, b)
    counts = P.np_(args[6])
    c_sorted, c_shuf = P.np_(o_sorted[5]), P.np_(o_shuf[5])
    for r, p in enumerate(perms):
        c = int(counts[r])
        P.assert_equal(c_shuf[r, :c], c_sorted[r, :c][p])
        P.assert_equal(c_shuf[r, c:], 0.0)
    # ... and still matches the reference's fused kernel on sorted lanes.
    _assert_outputs(o_shuf[:5] + (o_sorted[5],), jops.raster_tiles(
        *tile_inputs[capacity], impl="pallas_fused", chunk=chunk))


@pytest.mark.parametrize("capacity,chunk", [(64, 16), (128, 64)])
def test_plain_version_counts_its_work(tile_inputs, capacity, chunk):
    """``work`` counts the (pixel, real lane) pairs reached before the
    pixel's T falls below T_EPS, and those with a nonzero weight, as a
    whole-row transmittance product over the sorted lanes counts them
    (a pair may flip where the chunked product rounds across T_EPS)."""
    args = _torch_args(tile_inputs[capacity])
    mean2d, conic, rgb, opacity, depth, origins, counts = args
    work = {}
    trp.raster_plan_torch(*args, chunk=chunk, work=work)
    px, py = tref.pixel_coords(origins)
    dx = px[:, :, None] - mean2d[:, None, :, 0]
    dy = py[:, :, None] - mean2d[:, None, :, 1]
    power = (-0.5 * (conic[:, None, :, 0] * dx * dx
                     + conic[:, None, :, 2] * dy * dy)
             - conic[:, None, :, 1] * dx * dy)
    alpha = tref.alpha_of(opacity[:, None, :], power)
    t_after = torch.cumprod(1.0 - alpha, dim=2)
    t_before = torch.cat([torch.ones_like(t_after[..., :1]),
                          t_after[..., :-1]], dim=2)
    real = (torch.arange(opacity.shape[1])[None] < counts[:, None])[:, None]
    live = (t_before >= tref.T_EPS) & real
    evaluated = int(live.sum())
    blended = int((live & (t_after >= tref.T_EPS) & (alpha > 0)).sum())
    assert 0 < blended < evaluated <= int(counts.sum()) * 256
    assert abs(work["evaluated"] - evaluated) <= 1e-3 * evaluated
    assert abs(work["blended"] - blended) <= 1e-3 * blended


@pytest.mark.parametrize("capacity,chunk", [(64, 16), (128, 64)])
def test_plain_version_counts_warp_chunks(tile_inputs, capacity, chunk):
    """``work["warp_chunks"]`` counts the (warp, chunk) pairs the CUDA
    blend runs: chunks below the slot's count that start with one of the
    warp's 32 pixels not yet done, as the whole-row transmittance at each
    chunk's end decides it (a pixel may flip where the chunked product
    rounds across T_EPS)."""
    mean2d, conic, rgb, opacity, depth, origins, counts = _torch_args(
        tile_inputs[capacity])
    # Wide, near-opaque splats on the odd slots, so that whole warps
    # finish early there and skip chunks.
    odd = (torch.arange(opacity.shape[0]) % 2 == 1)[:, None]
    opacity = torch.where(odd & (opacity > 0), 0.99, opacity)
    conic = torch.where(odd[..., None], conic * 1e-4, conic)
    args = (mean2d, conic, rgb, opacity, depth, origins, counts)
    work = {}
    trp.raster_plan_torch(*args, chunk=chunk, work=work)
    px, py = tref.pixel_coords(origins)
    dx = px[:, :, None] - mean2d[:, None, :, 0]
    dy = py[:, :, None] - mean2d[:, None, :, 1]
    power = (-0.5 * (conic[:, None, :, 0] * dx * dx
                     + conic[:, None, :, 2] * dy * dy)
             - conic[:, None, :, 1] * dx * dy)
    alpha = tref.alpha_of(opacity[:, None, :], power)
    t_end = torch.cumprod(1.0 - alpha, dim=2)[..., chunk - 1::chunk]
    # Pixel done before chunk i: some earlier chunk ended below T_EPS.
    done_before = torch.cat([torch.zeros_like(t_end[..., :1], dtype=bool),
                             torch.cummax((t_end < tref.T_EPS).int(),
                                          dim=2)[0][..., :-1].bool()], dim=2)
    r, p, n = done_before.shape
    warp_live = (~done_before).reshape(r, p // 32, 32, n).any(dim=2)
    below = torch.arange(n)[None] * chunk < counts[:, None]
    want = int((warp_live & below[:, None]).sum())
    upper = int(((counts + chunk - 1) // chunk).sum()) * (p // 32)
    assert 0 < want < upper
    assert abs(work["warp_chunks"] - want) <= 1e-2 * want


def test_masked_slots_render_empty(tile_inputs):
    m, c, r, o, d, org, counts = _torch_args(tile_inputs[64])
    active = torch.arange(counts.shape[0]) % 2 == 0
    counts_m = torch.where(active, counts, 0)
    out = tops.raster_tiles(m, c, r, o, d, org, counts_m, impl="cuda_fused",
                            chunk=32, slot_active=active)
    full = tops.raster_tiles(m, c, r, o, d, org, counts, impl="cuda_fused",
                             chunk=32)
    off = ~active
    assert bool((out[0][off] == 0).all() and (out[1][off] == 1).all())
    assert bool((out[4][off] == 0).all() and (out[5][off] == 0).all())
    for a, b in zip(out, full):
        P.assert_equal(a[active], b[active])
    # A masked slot stays empty even with a stale nonzero count.
    out2 = tops.raster_tiles(m, c, r, o, d, org, counts, impl="cuda_fused",
                             chunk=32, slot_active=active)
    for a, b in zip(out2, out):
        P.assert_equal(a, b)


@pytest.mark.parametrize("impl", ["cuda_fused", "cuda", "torch_chunked",
                                  "ref"])
def test_empty_input_renders_background(impl):
    t, k = 6, 64
    z = torch.zeros
    out = tops.raster_tiles(z((t, k, 2)), torch.ones((t, k, 3)),
                            z((t, k, 3)), z((t, k)), z((t, k)), z((t, 2)),
                            z((t,), dtype=torch.int32), impl=impl, chunk=32)
    assert bool((out[0] == 0).all() and (out[1] == 1).all())
    assert int(out[4].sum()) == 0 and bool((out[5] == 0).all())


def test_shape_errors_mirror_reference(tile_inputs):
    args = _torch_args(tile_inputs[96])
    with pytest.raises(ValueError, match="power of two"):
        tops.raster_tiles(*args, impl="cuda_fused", chunk=48)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.raster_tiles(*args, impl="torch_chunked", chunk=64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.raster_tiles(*args, impl="cuda", chunk=64)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.raster_tiles(*args, impl="pallas", chunk=32)


def test_default_impl_and_cpu_wrapper():
    assert tops.default_impl("cpu") == "torch_chunked"
    assert tops.default_impl("cuda") == "cuda_fused"
    assert tops.RASTER_IMPLS == ("cuda_fused", "cuda", "torch_chunked",
                                 "ref")
    fused, tile = kernel_launches("raster_plan_fused"), \
        kernel_launches("raster_tile")
    before = fused.value
    z = torch.zeros
    trp.raster_plan_fused(z((2, 16, 2)), z((2, 16, 3)), z((2, 16, 3)),
                          z((2, 16)), z((2, 16)), z((2, 2)),
                          z((2,), dtype=torch.int32), chunk=16)
    assert fused.value == before  # CPU: plain version
    before = tile.value
    trt.raster_tile(z((2, 16, 2)), z((2, 16, 3)), z((2, 16, 3)), z((2, 16)),
                    z((2, 16)), z((2, 2)), z((2,), dtype=torch.int32),
                    chunk=16)
    assert tile.value == before


def test_untile_tile_view(small_cam):
    rng = np.random.default_rng(1)
    tiles = rng.uniform(size=(small_cam.num_tiles, 16, 16, 3))
    tiles = tiles.astype(np.float32)
    img = traster.untile(torch.from_numpy(tiles), small_cam.tiles_x,
                         small_cam.tiles_y)
    P.assert_equal(img, jraster.untile(jnp.asarray(tiles), small_cam.tiles_x,
                                       small_cam.tiles_y))
    P.assert_equal(traster.tile_view(img, small_cam.tiles_x,
                                     small_cam.tiles_y), tiles)


def test_render_from_bins_matches_reference(small_scene, small_cam):
    jp = jproj.preprocess(small_scene, small_cam)
    grid = jint.make_tile_grid(small_cam)
    jb = jbin.build_tile_bins(jint.tait_mask(jp, grid), jp.depth, 64)
    want = jraster.render_from_bins(jp, jb, grid, impl="jnp_chunked",
                                    chunk=32)
    tp = P.projected(jp)
    tgrid = tint.make_tile_grid(P.camera(small_cam))
    tb = tbin.build_tile_bins(tint.tait_mask(tp, tgrid), tp.depth, 64)
    got = traster.render_from_bins(tp, tb, tgrid, impl="torch_chunked",
                                   chunk=32)
    for name in ("rgb", "transmittance", "exp_depth", "trunc_depth"):
        P.assert_close(getattr(got, name), getattr(want, name), atol=ATOL,
                       err_msg=name)
    P.assert_equal(got.processed_pairs, want.processed_pairs)
    P.assert_close(got.gauss_contrib, want.gauss_contrib,
                   rtol=CONTRIB_RTOL, atol=1e-5)


@pytest.mark.parametrize("impl", ["torch_chunked", "cuda_fused"])
def test_full_plan_equals_dense_render(small_scene, small_cam, impl):
    """The all-tiles plan (Morton-permuted slots + scatter back) is a pure
    reordering of the dense ``render_from_bins`` render."""
    cfg = tpipe.RenderConfig(impl=impl)
    scene, cam = P.scene(small_scene), P.camera(small_cam)
    out, _, rec = tpipe.render_full_frame(scene, cam, cfg)
    proj = tproj.preprocess(scene, cam, near=cfg.near)
    grid = tint.make_tile_grid(cam)
    bins = tbin.build_tile_bins(tint.tait_mask(proj, grid), proj.depth,
                                cfg.capacity)
    ref = traster.render_from_bins(proj, bins, grid, impl=impl)
    P.assert_close(out.rgb, ref.rgb, atol=1e-6)
    P.assert_equal(out.processed_pairs, ref.processed_pairs)
    P.assert_equal(rec.sort_pairs, bins.count)


def test_raster_tile_ref_single_tile(tile_inputs):
    """The one-tile oracle equals the reference's for one slot."""
    jargs = tile_inputs[64]
    i = int(np.argmax(np.asarray(jargs[6])))  # the busiest tile
    want = jref.raster_tile_ref(*(a[i] for a in jargs[:6]))
    got = tref.raster_tile_ref(*(P.tensor(a[i]) for a in jargs[:6]))
    for g, w in zip(got[:4], want[:4]):
        P.assert_close(g, w, atol=ATOL)
    P.assert_equal(got[4], want[4])
    P.assert_close(got[5], want[5], rtol=CONTRIB_RTOL, atol=1e-6)


def _scatter_inputs():
    """Indices with long runs of ties and values whose float sum depends
    on the order of the adds."""
    gen = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 64, (20000,), generator=gen, dtype=torch.int32)
    vals = torch.randn((20000, 3), generator=gen) * 1e3
    return idx, vals


def _in_order(size, idx, vals):
    out = torch.zeros((size,) + tuple(vals.shape[1:]), dtype=vals.dtype)
    for i, v in zip(idx.tolist(), vals):
        out[i] += v
    return out


def test_scatter_add_restores_deterministic_mode():
    """With the mode off and on, the sums are in element order and the
    mode reads what the caller set."""
    idx = torch.tensor([3, 1, 3, 0])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0])
    big_idx, big_vals = _scatter_inputs()
    want = _in_order(64, big_idx, big_vals)
    before = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            out = traster.scatter_add(5, idx, vals)
            assert torch.equal(out, torch.tensor([4.0, 2.0, 0.0, 4.0, 0.0]))
            got = traster.scatter_add(64, big_idx, big_vals)
            assert torch.equal(got, want)
            assert torch.are_deterministic_algorithms_enabled() == mode
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn_only)


def test_scatter_add_from_threads_leaves_the_mode_alone():
    """Two threads summing at once (as the slot split's groups render)
    each get the single-threaded bits, and the deterministic mode, held
    off and then on by the caller, never changes under them."""
    idx, vals = _scatter_inputs()
    want = traster.scatter_add(64, idx, vals)
    before = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            modes, results = [], []

            def work():
                for _ in range(20):
                    results.append(traster.scatter_add(64, idx, vals))
                    modes.append(torch.are_deterministic_algorithms_enabled())

            threads = [threading.Thread(target=work) for _ in range(2)]
            for t in threads:
                t.start()
            for _ in range(200):
                modes.append(torch.are_deterministic_algorithms_enabled())
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            assert len(results) == 40
            assert all(torch.equal(r, want) for r in results)
            assert set(modes) == {mode}
    finally:
        sys.setswitchinterval(interval)
        torch.use_deterministic_algorithms(before, warn_only=warn_only)
