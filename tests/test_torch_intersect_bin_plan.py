"""Port parity: intersection masks, binning, plans and the LDU schedule
against the JAX reference (CPU). Masks, bins, plans and schedules are
integer/boolean results and must agree exactly on identical inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import binning as jbin
from repro.core import intersect as jint
from repro.core import load_balance as jlb
from repro.core import plan as jplan
from repro.core import projection as jproj
from repro_torch.core import binning as tbin
from repro_torch.core import intersect as tint
from repro_torch.core import load_balance as tlb
from repro_torch.core import plan as tplan

METHODS = ["aabb", "obb", "tait_stage1", "tait", "exact"]


@pytest.fixture(scope="module")
def projected(small_scene, small_cam, blob_scene, wide_cam):
    out = {}
    for name, scene, cam in (("small", small_scene, small_cam),
                             ("wide", blob_scene, wide_cam)):
        jp = jax.jit(jproj.preprocess)(scene, cam)
        jg = jint.make_tile_grid(cam)
        out[name] = (jp, jg, P.projected(jp), tint.make_tile_grid(
            P.camera(cam)))
    return out


@pytest.mark.parametrize("which", ["small", "wide"])
@pytest.mark.parametrize("method", METHODS)
def test_masks_exact(projected, which, method):
    jp, jg, tp, tg = projected[which]
    want = jint.intersect(jp, jg, method)
    got = tint.intersect(tp, tg, method)
    assert got.dtype == torch.bool
    P.assert_equal(got, want)
    P.assert_equal(tint.pair_count(got), jint.pair_count(want))
    P.assert_equal(tint.per_tile_count(got), jint.per_tile_count(want))


def test_tile_grid_and_take_tiles(projected):
    jp, jg, tp, tg = projected["wide"]
    P.assert_equal(tg.origins, jg.origins)
    P.assert_equal(tg.centers, jg.centers)
    assert (tg.tiles_x, tg.tiles_y, tg.num_tiles) == \
        (jg.tiles_x, jg.tiles_y, jg.num_tiles)
    ids = np.array([5, 0, 17, 3, 40], np.int32)
    js = jint.take_tiles(jg, jnp.asarray(ids))
    ts = tint.take_tiles(tg, torch.from_numpy(ids))
    P.assert_equal(ts.origins, js.origins)
    P.assert_equal(tint.tait_mask(tp, ts), jint.tait_mask(jp, js))


@pytest.mark.parametrize("which,capacity", [("small", 64), ("small", 600),
                                            ("wide", 16), ("wide", 128)])
@pytest.mark.parametrize("with_limit", [False, True])
def test_build_tile_bins(projected, which, capacity, with_limit):
    jp, jg, tp, tg = projected[which]
    jmask = jint.tait_mask(jp, jg)
    limit = None
    if with_limit:
        rng = np.random.default_rng(capacity)
        lim = rng.uniform(3.0, 9.0, jg.num_tiles).astype(np.float32)
        lim[::4] = np.inf
        limit = lim
    want = jbin.build_tile_bins(jmask, jp.depth, capacity,
                                depth_limit=None if limit is None
                                else jnp.asarray(limit))
    got = tbin.build_tile_bins(tint.tait_mask(tp, tg), tp.depth, capacity,
                               depth_limit=None if limit is None
                               else torch.from_numpy(limit))
    assert got.indices.dtype == torch.int32 and got.count.dtype == torch.int32
    assert got.capacity == want.capacity
    P.assert_equal(got.count, want.count)
    P.assert_equal(got.overflow, want.overflow)
    P.assert_equal(got.valid, want.valid)
    valid = np.asarray(want.valid)
    P.assert_equal(P.np_(got.indices)[valid], np.asarray(want.indices)[valid])
    assert int(got.total_pairs) == int(want.total_pairs)
    if capacity == 16:
        assert int(np.asarray(want.overflow).sum()) > 0  # overflow is hit


def test_build_tile_bins_breaks_depth_ties_by_index():
    """Equal depths: lower Gaussian index first, as lax.top_k does."""
    depth = np.array([2.0, 1.0, 2.0, 1.0, 3.0, 2.0], np.float32)
    mask = np.ones((6, 2), bool)
    mask[3, 1] = False
    want = jbin.build_tile_bins(jnp.asarray(mask), jnp.asarray(depth), 4)
    got = tbin.build_tile_bins(torch.from_numpy(mask),
                               torch.from_numpy(depth), 4)
    P.assert_equal(got.indices, want.indices)
    P.assert_equal(got.indices[0], [1, 3, 0, 2])


def test_gather_tiles(projected):
    jp, jg, tp, tg = projected["small"]
    jb = jbin.build_tile_bins(jint.tait_mask(jp, jg), jp.depth, 64)
    tb = tbin.build_tile_bins(tint.tait_mask(tp, tg), tp.depth, 64)
    want = jbin.gather_tiles(jp, jb)
    got = tbin.gather_tiles(tp, tb)
    valid = np.asarray(jb.valid)
    for name in want._fields:
        g, w = P.np_(getattr(got, name)), np.asarray(getattr(want, name))
        P.assert_equal(g[valid], w[valid], err_msg=name)
    P.assert_equal(got.opacity, want.opacity)   # invalid lanes: 0
    P.assert_equal(got.depth, want.depth)       # invalid lanes: 0, not inf


@pytest.mark.parametrize("tx,ty", [(4, 4), (8, 6), (7, 5), (120, 68)])
def test_morton_rank_and_full_plan(tx, ty):
    P.assert_equal(tlb.morton_rank(tx, ty, device="cpu"),
                   jlb.morton_rank(tx, ty))
    want = jplan.full_plan(tx, ty)
    got = tplan.full_plan(tx, ty, device="cpu")
    for name in want._fields:
        P.assert_equal(getattr(got, name), getattr(want, name),
                       err_msg=name)


@pytest.mark.parametrize("capacity", [None, 8, 2])
def test_sparse_plan(capacity):
    rng = np.random.default_rng(11)
    rerender = rng.uniform(size=48) < 0.3
    want = jplan.sparse_plan(jnp.asarray(rerender), 8, 6, capacity)
    got = tplan.sparse_plan(torch.from_numpy(rerender), 8, 6, capacity)
    for name in want._fields:
        P.assert_equal(getattr(got, name), getattr(want, name),
                       err_msg=name)
    if capacity == 2:
        assert int(got.overflow_tiles) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_plan_scatter_and_loads(seed):
    rng = np.random.default_rng(seed)
    rerender = rng.uniform(size=48) < 0.6
    jp = jplan.sparse_plan(jnp.asarray(rerender), 8, 6, 20)
    tp = tplan.sparse_plan(torch.from_numpy(rerender), 8, 6, 20)
    wl = rng.integers(0, 300, size=20).astype(np.int32)
    wl[rng.uniform(size=20) < 0.2] = 7  # ties in the light-to-heavy order
    want = jplan.schedule_plan(jp, jnp.asarray(wl), 4)
    got = tplan.schedule_plan(tp, torch.from_numpy(wl), 4)
    for name in want._fields:
        P.assert_equal(getattr(got, name), getattr(want, name),
                       err_msg=name)
    P.assert_equal(tplan.block_loads(got, 4), jplan.block_loads(want, 4))
    for values, fill in ((got.workload, 0), (got.block_of, -1),
                         (got.slot_active, False)):
        jvals = jnp.asarray(P.np_(values))
        P.assert_equal(tplan.scatter_slots(got, values, 48, fill=fill),
                       jplan.scatter_slots(want, jvals, 48, fill=fill))
    img = rng.uniform(size=(20, 16, 16, 3)).astype(np.float32)
    P.assert_equal(tplan.scatter_slots(got, torch.from_numpy(img), 48),
                   jplan.scatter_slots(want, jnp.asarray(img), 48))


def test_rerender_demand():
    rng = np.random.default_rng(3)
    active = rng.uniform(size=(5, 48)) < 0.4
    over = rng.integers(0, 9, size=5)
    got = tplan.rerender_demand(torch.from_numpy(active),
                                torch.from_numpy(over))
    assert got.dtype == torch.int32
    P.assert_equal(got, jplan.rerender_demand(active, over))


def _workloads(seed, r):
    rng = np.random.default_rng(seed)
    # Heavy-tailed like real per-tile pair counts, with ties and zeros.
    wl = np.floor(rng.pareto(1.5, r) * 40).astype(np.int32)
    wl[rng.uniform(size=r) < 0.1] = 0
    active = rng.uniform(size=r) < 0.7
    return wl, active


@pytest.mark.parametrize("seed,r,blocks", [(0, 64, 4), (1, 300, 32),
                                           (2, 1000, 7), (3, 17, 32)])
def test_greedy_fill_and_order(seed, r, blocks):
    wl, active = _workloads(seed, r)
    want = jlb.greedy_fill(jnp.asarray(wl), jnp.asarray(active), blocks)
    got = tlb.greedy_fill(torch.from_numpy(wl), torch.from_numpy(active),
                          blocks)
    assert got.dtype == torch.int32
    P.assert_equal(got, want)
    tie = np.random.default_rng(seed + 100).permutation(r).astype(np.int32)
    P.assert_equal(
        tlb.order_within_blocks(got, torch.from_numpy(wl),
                                torch.from_numpy(tie)),
        jlb.order_within_blocks(want, jnp.asarray(wl), jnp.asarray(tie)))


@pytest.mark.parametrize("policy", ["ls_gaussian", "static_blocked",
                                    "round_robin", "dynamic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ldu_schedule(policy, seed):
    wl, active = _workloads(seed, 8 * 6)
    kw = dict(policy=policy, tiles_x=8, tiles_y=6)
    want = jlb.ldu_schedule(jnp.asarray(wl), 5, active=jnp.asarray(active),
                            **kw)
    got = tlb.ldu_schedule(torch.from_numpy(wl), 5,
                           active=torch.from_numpy(active), **kw)
    for g, w in zip(got, want):
        P.assert_equal(g, w)
    # The numpy golden schedule agrees too (the reference pins it).
    gold = jlb.schedule(wl, 5, active=active, **kw)
    P.assert_equal(got[0], gold.block_of_tile)


def test_ldu_schedule_rejects_bad_policy():
    with pytest.raises(ValueError, match="unknown policy"):
        tlb.ldu_schedule(torch.zeros(4, dtype=torch.int32), 2, policy="x")
    with pytest.raises(ValueError, match="tiles_x"):
        tlb.ldu_schedule(torch.zeros(4, dtype=torch.int32), 2)
