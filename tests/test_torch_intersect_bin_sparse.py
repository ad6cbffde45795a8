"""The sparse TAIT intersect and binning (``kernels/intersect_bin.py``)
against the port's dense path (``pipeline.dense_intersect_and_bin``) and
the JAX reference (``repro.core.intersect`` TAIT masks, ``culling.
cull_pairs`` and ``binning.build_tile_bins`` over the plan's slots), on
the CPU. Every returned field must agree exactly: bins lane for lane
(invalid lanes included), counts, overflow, the stage-1 and culled
totals, raw pairs per slot and the slots' flags after the cull."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import binning as jbin
from repro.core import culling as jcull
from repro.core import intersect as jint
from repro.core import projection as jproj
from repro_torch.core import intersect as tint
from repro_torch.core import pipeline
from repro_torch.core import plan as tplan
from repro_torch.core.projection import ProjectedGaussians
from repro_torch.kernels import intersect_bin
from repro_torch.obs.metrics import PROCESS_METRICS, kernel_launches

TILES_X, TILES_Y = 7, 5
THRESHOLD = 0.5


def synthetic(seed, n=320):
    """Projected Gaussians over a 112 x 80 image (7 x 5 tiles), numpy
    float32: small and large boxes, depth ties, invalid rows (some with
    NaN and inf geometry), boxes whose edges lie on tile boundaries and
    one box over the whole grid."""
    rng = np.random.default_rng(seed)
    w, h = 16 * TILES_X, 16 * TILES_Y
    mean = np.stack([rng.uniform(-24, w + 24, n), rng.uniform(-24, h + 24, n)],
                    axis=1)
    half = rng.uniform(0.5, 14.0, (n, 2))
    half[rng.uniform(size=n) < 0.1] *= 5.0
    ang = rng.uniform(0, np.pi, n)
    minor = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    r_minor = half.min(axis=1) * rng.uniform(0.2, 1.0, n)
    depth = np.round(rng.uniform(0.5, 9.0, n) * 4.0) / 4.0   # ties
    valid = rng.uniform(size=n) < 0.9
    # Edges on tile boundaries: lo = 16, hi = 48; lo = 32, hi = 48.
    mean[:4] = [[32.0, 32.0], [40.0, 40.0], [48.0, 16.0], [16.0, 64.0]]
    half[:4] = [[16.0, 16.0], [8.0, 8.0], [16.0, 0.0], [0.0, 16.0]]
    r_minor[:4] = 40.0
    mean[4], half[4], r_minor[4] = [w / 2, h / 2], [1000.0, 1000.0], 900.0
    valid[:5] = True
    mean[5], valid[5] = [np.nan, 3.0], False
    half[6], valid[6] = [np.inf, 2.0], False
    mean[7], half[7], valid[7] = [40.0, 40.0], [30.0, 30.0], False
    f32 = np.float32
    return dict(mean2d=mean.astype(f32), tight_half_wh=half.astype(f32),
                minor_axis=minor.astype(f32), r_minor=r_minor.astype(f32),
                depth=depth.astype(f32), valid=valid)


def both(fields):
    """(JAX, port) ProjectedGaussians from numpy fields; the fields TAIT
    does not read are zeros."""
    n = fields["depth"].shape[0]
    shapes = dict(mean2d=(n, 2), cov2d=(n, 3), conic=(n, 3), depth=(n,),
                  rgb=(n, 3), opacity=(n,), radius3=(n,), eigvals=(n, 2),
                  minor_axis=(n, 2), r_major=(n,), r_minor=(n,),
                  tight_half_wh=(n, 2), valid=(n,))
    vals = {k: fields.get(k, np.zeros(s, np.float32))
            for k, s in shapes.items()}
    jp = jproj.ProjectedGaussians(**{k: jnp.asarray(v)
                                     for k, v in vals.items()})
    tp = ProjectedGaussians(**{k: torch.from_numpy(np.array(v))
                               for k, v in vals.items()})
    return jp, tp


def grids(tiles_x, tiles_y):
    """(JAX, port) tile grids as ``make_tile_grid`` lays them out."""
    t = torch.arange(tiles_x, dtype=torch.float32) * 16
    u = torch.arange(tiles_y, dtype=torch.float32) * 16
    ox, oy = torch.meshgrid(t, u, indexing="xy")
    origins = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)
    tg = tint.TileGrid(tiles_x, tiles_y, origins + 8.0, origins)
    jg = jint.TileGrid(tiles_x, tiles_y, jnp.asarray(tg.centers.numpy()),
                       jnp.asarray(origins.numpy()))
    return jg, tg


def make_plan(kind, tiles_x, tiles_y, seed):
    if kind == "full":
        return tplan.full_plan(tiles_x, tiles_y, device="cpu")
    rng = np.random.default_rng(seed)
    t = tiles_x * tiles_y
    rerender = torch.from_numpy(rng.uniform(size=t) < 0.5)
    # R above the re-render count: the tail slots are inactive padding.
    return tplan.sparse_plan(rerender, tiles_x, tiles_y, t * 3 // 4)


def inputs(kind, limit_kind, cull, fields, seed):
    """The plan, the (R,) DPES limit and the (prior, gate) cull. The cull
    keeps only Gaussians whose box starts right of x = 30 (a tenth of
    them with an infinite prior), and gates the first tile column on, so
    its slots lose every pair."""
    rng = np.random.default_rng(seed + 1)
    n, t = fields["depth"].shape[0], TILES_X * TILES_Y
    plan = make_plan(kind, TILES_X, TILES_Y, seed)
    r = plan.num_slots
    limit = None
    if limit_kind == "finite":
        limit = torch.from_numpy(rng.uniform(2.0, 8.0, r).astype(np.float32))
    elif limit_kind == "mixed":
        lim = rng.uniform(2.0, 8.0, r).astype(np.float32)
        lim[::3] = np.inf
        limit = torch.from_numpy(lim)
    cull_in = None
    if cull:
        lo_x = fields["mean2d"][:, 0] - fields["tight_half_wh"][:, 0]
        prior = np.where(lo_x > 30.0, rng.uniform(0.6, 3.0, n),
                         rng.uniform(0.0, 0.45, n)).astype(np.float32)
        prior[(lo_x > 30.0) & (rng.uniform(size=n) < 0.1)] = np.inf
        gate = rng.uniform(size=t) < 0.8
        gate[::TILES_X] = True
        cull_in = (torch.from_numpy(prior), torch.from_numpy(gate))
    return plan, limit, cull_in


def reference(jp, jg, plan, capacity, limit, cull):
    """The JAX reference's intersect, cull and binning over the plan's
    slots (``repro/core/pipeline.render_planned_frame``'s steps)."""
    tile_ids = jnp.asarray(P.np_(plan.tile_ids))
    active = jnp.asarray(P.np_(plan.slot_active))
    slots = jint.take_tiles(jg, tile_ids)
    stage1 = jint.tait_stage1_mask(jp, slots)
    mask = jint.tait_mask(jp, slots)
    cand = jnp.sum((stage1 & active[None, :]).astype(jnp.int32))
    mask = mask & active[None, :]
    culled = jnp.int32(0)
    if cull is not None:
        mask, active, culled = jcull.cull_pairs(
            mask, active, tile_ids, jnp.asarray(P.np_(cull[0])),
            jnp.asarray(P.np_(cull[1])), THRESHOLD)
    raw = jnp.sum(mask.astype(jnp.int32), axis=0)
    bins = jbin.build_tile_bins(
        mask, jp.depth, capacity,
        depth_limit=None if limit is None else jnp.asarray(P.np_(limit)))
    return bins, cand, raw, culled, active


def assert_same(got, want, what):
    (gb, *gs), (wb, *ws) = got, want
    for name in ("indices", "valid", "count", "overflow"):
        g, w = getattr(gb, name), getattr(wb, name)
        assert g.dtype == (torch.bool if name == "valid" else torch.int32), \
            name
        P.assert_equal(g, w, err_msg=f"{what}: {name}")
    assert gb.capacity == wb.capacity
    for name, g, w in zip(("candidate_pairs", "raw_slots", "culled_pairs",
                           "slot_active"), gs, ws):
        P.assert_equal(g, w, err_msg=f"{what}: {name}")


def sparse(tp, tg, plan, capacity, limit, cull):
    cfg = pipeline.RenderConfig(capacity=capacity,
                                cull_threshold=THRESHOLD if cull else 0.0)
    return pipeline.intersect_and_bin(tp, tg, plan, cfg, limit, cull)


def dense(tp, tg, plan, capacity, limit, cull):
    cfg = pipeline.RenderConfig(capacity=capacity,
                                cull_threshold=THRESHOLD if cull else 0.0)
    return pipeline.dense_intersect_and_bin(tp, tg, plan, cfg, limit, cull)


@pytest.mark.parametrize("capacity", [4, 64, 4096])
@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("limit_kind", ["none", "finite", "mixed"])
@pytest.mark.parametrize("kind", ["full", "sparse"])
def test_sparse_equals_dense_and_reference(kind, limit_kind, cull, capacity):
    fields = synthetic(seed=capacity + 7 * cull)
    n = fields["depth"].shape[0]
    jp, tp = both(fields)
    jg, tg = grids(TILES_X, TILES_Y)
    plan, limit, cull_in = inputs(kind, limit_kind, cull, fields,
                                  seed=capacity)
    got = sparse(tp, tg, plan, capacity, limit, cull_in)
    assert_same(got, dense(tp, tg, plan, capacity, limit, cull_in),
                "dense")
    assert_same(got, reference(jp, jg, plan, capacity, limit, cull_in),
                "reference")
    bins, _, raw, _, active = got
    count_full = bins.count + bins.overflow
    if capacity == 4:
        assert int(bins.overflow.sum()) > 0       # the select branch
    if capacity == 64:
        assert int(count_full.max()) <= 64 < n    # every slot sorted whole
    if capacity == 4096:
        assert bins.indices.shape[1] == n         # K = N < capacity
    if kind == "sparse":
        assert not bool(plan.slot_active.all())   # padded slots
    if cull:
        # Some slot had pairs and lost them all to the cull.
        assert int((plan.slot_active & ~active).sum()) > 0
    if limit_kind != "none":
        assert int((raw - count_full).max()) > 0  # the limit dropped pairs


def test_boundary_and_whole_grid_boxes():
    """The edge cases alone: boxes whose edges lie on tile boundaries (a
    strict test at the boundary keeps them off the neighbour), one box
    over the whole grid, and invalid rows with NaN and inf geometry."""
    fields = {k: v[:8] for k, v in synthetic(seed=1).items()}
    jp, tp = both(fields)
    jg, tg = grids(TILES_X, TILES_Y)
    plan = tplan.full_plan(TILES_X, TILES_Y, device="cpu")
    got = sparse(tp, tg, plan, 8, None, None)
    assert_same(got, reference(jp, jg, plan, 8, None, None), "reference")
    mask = tint.tait_mask(tp, tg)
    # lo = 16, hi = 48 covers tiles 1 and 2 in x and y, and no more.
    assert mask[0].reshape(TILES_Y, TILES_X)[1:3, 1:3].all()
    assert int(mask[0].sum()) == 4
    assert int(mask[1].sum()) == 1
    assert bool(mask[4].all())          # the whole grid
    assert not bool(mask[5:].any())     # invalid rows
    assert int(got[0].count.sum()) == int(mask.sum())


@pytest.mark.parametrize("which", ["small", "wide"])
@pytest.mark.parametrize("with_limit", [False, True])
def test_projected_scenes(small_scene, small_cam, blob_scene, wide_cam,
                          which, with_limit):
    """Real projected scenes (the reference's preprocess) on a full plan."""
    scene, cam = (small_scene, small_cam) if which == "small" \
        else (blob_scene, wide_cam)
    jp = jax.jit(jproj.preprocess)(scene, cam)
    tp = P.projected(jp)
    jg = jint.make_tile_grid(cam)
    tg = tint.make_tile_grid(P.camera(cam))
    plan = tplan.full_plan(tg.tiles_x, tg.tiles_y, device="cpu")
    limit = None
    if with_limit:
        rng = np.random.default_rng(5)
        limit = torch.from_numpy(
            rng.uniform(3.0, 9.0, plan.num_slots).astype(np.float32))
    got = sparse(tp, tg, plan, 64, limit, None)
    assert_same(got, dense(tp, tg, plan, 64, limit, None), "dense")
    assert_same(got, reference(jp, jg, plan, 64, limit, None), "reference")


@pytest.mark.parametrize("tx,ty", [(7, 5), (120, 68), (62, 35)])
@pytest.mark.parametrize("share", [0.1, 0.6, 1.0])
def test_plans_hold_each_tile_once(tx, ty, share):
    """The kernel's tile -> slot map needs each tile in at most one slot:
    ``full_plan`` and ``sparse_plan`` take a permutation of the tiles."""
    plans = [tplan.full_plan(tx, ty, device="cpu")]
    rng = np.random.default_rng(tx * ty)
    rerender = torch.from_numpy(rng.uniform(size=tx * ty) < share)
    for cap in (None, tx * ty // 2, 3):
        plans.append(tplan.sparse_plan(rerender, tx, ty, cap))
    for p in plans:
        ids = p.tile_ids.long()
        assert ids.min() >= 0 and ids.max() < tx * ty
        assert torch.unique(ids).shape[0] == ids.shape[0]


def test_counters():
    """The pair total goes to ``intersect_pairs_total`` on either device;
    the kernel's launch counter moves only on the card."""
    fields = synthetic(seed=3)
    _, tp = both(fields)
    _, tg = grids(TILES_X, TILES_Y)
    plan = tplan.full_plan(TILES_X, TILES_Y, device="cpu")
    pairs_counter = PROCESS_METRICS.counter("intersect_pairs_total")
    launches = kernel_launches("intersect_bin")
    before, before_l = pairs_counter.value, launches.value
    bins = sparse(tp, tg, plan, 4096, None, None)[0]
    assert pairs_counter.value - before == int(bins.count.sum())
    assert launches.value == before_l


def _cpu_args():
    fields = synthetic(seed=2, n=64)
    _, tp = both(fields)
    _, tg = grids(TILES_X, TILES_Y)
    plan = tplan.full_plan(TILES_X, TILES_Y, device="cpu")
    return tp, tg, plan


def test_cuda_wrapper_refusals():
    tp, tg, plan = _cpu_args()
    # CPU tensors: the kernel never falls back to the plain version.
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        intersect_bin.intersect_pairs_cuda(tp, tg, plan.tile_ids,
                                           plan.slot_active)
    pairs = intersect_bin.intersect_pairs_torch(tp, tg, plan.tile_ids,
                                                plan.slot_active)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        intersect_bin.select_bins_cuda(pairs, 16)
    with pytest.raises(ValueError, match="takes 1 to 4096"):
        intersect_bin.select_bins_cuda(pairs._replace(n=5000), 5000)
    with pytest.raises(TypeError, match="count_full must be int32"):
        intersect_bin.select_bins_cuda(
            pairs._replace(count_full=pairs.count_full.long()), 16)
    # Non-contiguous inputs.
    wide = torch.zeros((tp.depth.shape[0], 4), dtype=torch.float32)
    wide[:, :2] = tp.mean2d
    with pytest.raises(ValueError, match="mean2d must be contiguous"):
        intersect_bin.intersect_pairs_cuda(
            tp._replace(mean2d=wide[:, :2]), tg, plan.tile_ids,
            plan.slot_active)
    with pytest.raises(ValueError, match="keys must be contiguous"):
        intersect_bin.select_bins_cuda(
            pairs._replace(keys=torch.stack([pairs.keys] * 2, 1)[:, 0]), 16)


@pytest.mark.parametrize("case", ["dtype_ids", "dtype_depth", "shape_limit",
                                  "device_gate", "dtype_keep"])
def test_wrapper_refuses_bad_inputs(case):
    """Both versions check dtypes, shapes and devices before any work."""
    tp, tg, plan = _cpu_args()
    n, r, t = tp.depth.shape[0], plan.num_slots, tg.num_tiles
    ids, limit = plan.tile_ids, None
    cull = None
    err = TypeError
    if case == "dtype_ids":
        ids = ids.long()
    elif case == "dtype_depth":
        tp = tp._replace(depth=tp.depth.double())
    elif case == "shape_limit":
        limit, err = torch.ones(r + 1), ValueError
    elif case == "device_gate":
        cull = (torch.ones(n, dtype=torch.bool),
                torch.ones(t, dtype=torch.bool, device="meta"))
        err = ValueError
    elif case == "dtype_keep":
        cull = (torch.ones(n), torch.ones(t, dtype=torch.bool))
    for fn in (intersect_bin.intersect_pairs,
               intersect_bin.intersect_pairs_cuda):
        with pytest.raises(err):
            fn(tp, tg, ids, plan.slot_active, limit, cull)
