"""Port parity: the LDU's numpy golden (``schedule``, ``morton_order``,
``load_stats``), the torch ``ldu_schedule`` and the fills of the LDU
kernel, against the JAX reference (CPU). Schedules are integer results
and must agree exactly.

The kernel (``csrc/ldu_fill.cu``) runs only on the card; here a numpy
model of its lane algorithm — slots in groups of 32 under a ballot,
placed one a step, lane ``l`` owning blocks ``l, l + 32, ...``, a
deferral decided by a min-reduce of the fitting blocks' cyclic rank
and, where none fits, by two min-reduces over (order key, index) — is
held exactly to the plain version's scan
(``kernels/ldu_fill.py::ldu_fill_host``). chip_smoke.py holds the kernel
to the plain version on the card (phase 2e)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import load_balance as jlb
from repro_torch.core import load_balance as tlb
from repro_torch.kernels import ldu_fill as kl
from repro_torch.obs.metrics import kernel_launches

POLICIES = ("static_blocked", "round_robin", "dynamic", "ls_gaussian")
BLOCKS = (1, 3, 32, 33)


def _workloads(seed, t, active_frac):
    """Heavy-tailed per-tile pair counts with ties and zeros."""
    rng = np.random.default_rng(seed)
    wl = np.floor(rng.pareto(1.5, t) * 60).astype(np.int64)
    wl[rng.uniform(size=t) < 0.1] = 0
    wl[rng.uniform(size=t) < 0.1] = 7
    active = None if active_frac is None else rng.uniform(size=t) < active_frac
    return wl, active


def _assert_schedules_equal(got, want, err=""):
    assert got.num_blocks == want.num_blocks, err
    np.testing.assert_array_equal(got.block_of_tile, want.block_of_tile,
                                  err_msg=err)
    np.testing.assert_array_equal(got.order_in_block, want.order_in_block,
                                  err_msg=err)
    assert got.block_of_tile.dtype == want.block_of_tile.dtype


@pytest.mark.parametrize("tx,ty", [(4, 4), (8, 6), (16, 16), (120, 68)])
def test_morton_order(tx, ty):
    got = tlb.morton_order(tx, ty)
    np.testing.assert_array_equal(got, jlb.morton_order(tx, ty))
    rank = tlb.morton_rank(tx, ty, device="cpu").numpy()
    np.testing.assert_array_equal(np.argsort(rank, kind="stable"), got)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("b", BLOCKS)
@pytest.mark.parametrize("active_frac", [None, 0.4])
def test_golden_schedule_and_load_stats(policy, b, active_frac):
    for seed in range(4):
        tx, ty = (8, 6) if seed % 2 else (16, 12)
        wl, active = _workloads(seed, tx * ty, active_frac)
        kw = dict(policy=policy, tiles_x=tx, tiles_y=ty, active=active)
        want = jlb.schedule(wl, b, **kw)
        got = tlb.schedule(wl, b, **kw)
        err = f"{policy} b={b} seed={seed}"
        _assert_schedules_equal(got, want, err)
        ls_got, ls_want = tlb.load_stats(got, wl), jlb.load_stats(want, wl)
        assert ls_got.keys() == ls_want.keys()
        np.testing.assert_array_equal(ls_got["block_loads"],
                                      ls_want["block_loads"], err_msg=err)
        assert ls_got["max_over_mean"] == ls_want["max_over_mean"], err
        assert ls_got["cv"] == ls_want["cv"], err


def test_golden_schedule_edges():
    wl = np.arange(16)
    for policy in POLICIES:
        kw = dict(policy=policy, tiles_x=4, tiles_y=4)
        none = np.zeros(16, bool)
        _assert_schedules_equal(tlb.schedule(wl, 4, active=none, **kw),
                                jlb.schedule(wl, 4, active=none, **kw))
        _assert_schedules_equal(tlb.schedule(wl, 0, **kw),
                                jlb.schedule(wl, 0, **kw))
    with pytest.raises(ValueError, match="unknown policy"):
        tlb.schedule(wl, 4, policy="x")
    with pytest.raises(ValueError, match="tiles_x"):
        tlb.schedule(wl, 4, policy="ls_gaussian")


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=1, max_size=64),
       st.integers(1, 40), st.sampled_from(POLICIES), st.booleans())
def test_golden_schedule_property(workloads, b, policy, masked):
    w = np.zeros(64, np.int64)
    w[:len(workloads)] = workloads
    active = (np.arange(64) % 3 != 0) if masked else None
    kw = dict(policy=policy, tiles_x=8, tiles_y=8, active=active)
    _assert_schedules_equal(tlb.schedule(w, b, **kw),
                            jlb.schedule(w, b, **kw))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("b", BLOCKS)
@pytest.mark.parametrize("active_frac", [None, 0.0, 0.4])
def test_ldu_schedule_matches_reference(policy, b, active_frac):
    """The port's torch ldu_schedule (plain fills on CPU tensors) equals
    the reference's jitted ldu_schedule exactly, and the golden's block
    assignment."""
    tx, ty = 16, 12
    wl, active = _workloads(b + 11, tx * ty, active_frac)
    act = np.ones(tx * ty, bool) if active is None else active
    fn = jax.jit(lambda w, a: jlb.ldu_schedule(
        w, b, policy=policy, tiles_x=tx, tiles_y=ty, active=a))
    want = fn(jnp.asarray(wl.astype(np.int32)), jnp.asarray(act))
    got = tlb.ldu_schedule(torch.from_numpy(wl.astype(np.int32)), b,
                           policy=policy, tiles_x=tx, tiles_y=ty,
                           active=None if active is None
                           else torch.from_numpy(active))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gold = jlb.schedule(wl, b, policy=policy, tiles_x=tx, tiles_y=ty,
                        active=active)
    np.testing.assert_array_equal(got[0].numpy(), gold.block_of_tile)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 3000), min_size=1, max_size=48),
       st.integers(1, 40), st.sampled_from(POLICIES))
def test_ldu_schedule_property(workloads, b, policy):
    w = np.zeros(48, np.int32)
    w[:len(workloads)] = workloads
    act = np.arange(48) % 5 != 2
    want = jlb.ldu_schedule(jnp.asarray(w), b, policy=policy, tiles_x=8,
                            tiles_y=6, active=jnp.asarray(act))
    got = tlb.ldu_schedule(torch.from_numpy(w), b, policy=policy,
                           tiles_x=8, tiles_y=6,
                           active=torch.from_numpy(act))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("b", [7, 32, 33])
def test_fills_at_total_above_2_24(seed, b):
    """Totals past 2**24: the port sums the active workloads exactly and
    rounds once; the reference's float32 ``jnp.sum`` may round on the way
    (by 2 units on some seeds). The caps then differ by ulps; the fills
    still agree on these inputs, and the golden schedule (float64) agrees
    with itself across the packages."""
    rng = np.random.default_rng(seed + 3)
    r = 32768
    wl = rng.integers(0, 1100, size=r).astype(np.int32)
    act = rng.uniform(size=r) < 0.97
    total = int(wl[act].sum())
    assert total >= 2 ** 24
    f32 = np.float32
    w_ideal = max(f32(total) / f32(b), f32(1.0))
    n_avg = max(f32(int(act.sum())) / f32(b), f32(1.0))
    assert kl.fill_cap(wl.astype(f32), act, b) == \
        (f32(1.0) + f32(1.0) / n_avg) * w_ideal
    for mode, want in (
            ("greedy", jlb.greedy_fill(jnp.asarray(wl), jnp.asarray(act), b)),
            ("dynamic", jlb.ldu_schedule(jnp.asarray(wl), b,
                                         policy="dynamic",
                                         active=jnp.asarray(act))[0])):
        got = kl.ldu_fill(torch.from_numpy(wl), torch.from_numpy(act), b,
                          mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=mode)
    tx, ty = 256, 128
    kw = dict(policy="ls_gaussian", tiles_x=tx, tiles_y=ty, active=act)
    _assert_schedules_equal(tlb.schedule(wl, b, **kw),
                            jlb.schedule(wl, b, **kw))


# ---------------------------------------------------------------------------
# The kernel's lane algorithm, modelled in numpy.
# ---------------------------------------------------------------------------

WARP = 32
NONE = 0xFFFFFFFF


def _order_key(a):
    """csrc/ldu_fill.cu::order_key: uint32 with the float32's order."""
    u = np.float32(a).view(np.uint32)
    return int(~u & 0xFFFFFFFF) if u & 0x80000000 else int(u | 0x80000000)


def _lane_least(acc, b, lane):
    key, j_best = NONE, NONE
    for j in range(lane, b, WARP):
        k = _order_key(acc[j])
        if k < key:
            key, j_best = k, j
    return key, j_best


def _warp_least(keys, js):
    least = min(keys)
    return min(j if k == least else NONE for k, j in zip(keys, js))


def _kernel_model(wl_i32, act, b, mode):
    """The kernel's steps as the lanes take them (f32 throughout)."""
    f32 = np.float32
    r = wl_i32.shape[0]
    wl = wl_i32.astype(f32)
    # Pass 1: per-lane int64 sums and counts, then the butterfly.
    total = sum(int(sum(int(wl[i]) for i in range(lane, r, WARP)
                        if act[i])) for lane in range(WARP))
    n_active = int(act.sum())
    w_ideal = max(f32(total) / f32(b), f32(1.0))
    n_avg = max(f32(n_active) / f32(b), f32(1.0))
    cap = (f32(1.0) + f32(1.0) / n_avg) * w_ideal
    acc = np.zeros(b, f32)        # s_acc: lane l touches j = l mod 32 only
    keys = [None] * WARP
    js = [None] * WARP
    for lane in range(WARP):
        keys[lane], js[lane] = _lane_least(acc, b, lane)
    state = {"cur": 0, "acc": f32(0.0)}
    out = np.full(r, -1, np.int32)

    def defer(w):
        cur = state["cur"]
        acc[cur] = state["acc"]
        ranks = []
        for lane in range(WARP):
            rank = NONE
            for j in range(lane, b, WARP):
                if acc[j] + w <= cap:
                    rank = min(rank, (j - cur - 1 + b) % b)
            ranks.append(rank)
        rank = min(ranks)
        if rank != NONE:
            tgt = (cur + 1 + rank) % b
        else:
            least = [_lane_least(acc, b, lane) for lane in range(WARP)]
            tgt = _warp_least([x[0] for x in least], [x[1] for x in least])
        state["acc"] = f32(acc[tgt] + w)
        state["cur"] = tgt
        return tgt

    for g in range(0, r, WARP):
        mask = [g + lane < r and bool(act[g + lane]) for lane in range(WARP)]
        pending = [lane for lane in range(WARP) if mask[lane]]
        for k in pending:
            w = wl[g + k]
            if mode == "dynamic":
                tgt = _warp_least(keys, js)
                owner = tgt % WARP
                acc[tgt] = acc[tgt] + w
                keys[owner], js[owner] = (
                    (_order_key(acc[tgt]), js[owner]) if b <= WARP
                    else _lane_least(acc, b, owner))
            elif state["acc"] + w <= cap:
                tgt = state["cur"]
                state["acc"] = f32(state["acc"] + w)
            else:
                tgt = defer(w)
            out[g + k] = tgt
    return out


def _fill_cases():
    rng = np.random.default_rng(5)
    r = 300
    heavy = np.floor(rng.pareto(1.2, r) * 30).astype(np.int32)
    ties = rng.integers(0, 3, size=r).astype(np.int32) * 10
    spike = np.ones(r, np.int32)
    spike[[40, 41, 200]] = 10 * r
    some = rng.uniform(size=r) < 0.3
    ones = np.ones(r, bool)
    return [("heavy", heavy, ones), ("heavy masked", heavy, some),
            ("ties", ties, ones), ("ties masked", ties, some),
            ("zeros", np.zeros(r, np.int32), ones),
            ("equal", np.full(r, 100, np.int32), ones),
            ("above the cap", spike, ones),
            ("none active", heavy, np.zeros(r, bool)),
            ("ragged", heavy[:77], some[:77]),
            ("sums past 2**24", np.full(r, 1 << 17, np.int32), ones),
            ("one past 2**24", np.where(np.arange(r) == 9, (1 << 24) + 3,
                                        heavy).astype(np.int32), ones)]


@pytest.mark.parametrize("mode", kl.MODES)
@pytest.mark.parametrize("b", [1, 7, 32, 33, 64, 70])
def test_kernel_lane_model_equals_plain(mode, b):
    for name, wl, act in _fill_cases():
        want = kl.ldu_fill_host(torch.from_numpy(wl), torch.from_numpy(act),
                                b, mode).numpy()
        got = _kernel_model(wl, act, b, mode)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} b={b}")


def test_plain_fills_equal_reference_scans():
    """The plain version's two modes against the reference's scans."""
    for name, wl, act in _fill_cases():
        for b in (1, 7, 33):
            got = kl.ldu_fill(torch.from_numpy(wl), torch.from_numpy(act), b)
            want = jlb.greedy_fill(jnp.asarray(wl), jnp.asarray(act), b)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name} b={b}")
            got = kl.ldu_fill(torch.from_numpy(wl), torch.from_numpy(act), b,
                              "dynamic")
            want = jlb.ldu_schedule(jnp.asarray(wl), b, policy="dynamic",
                                    active=jnp.asarray(act))[0]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"dynamic {name} b={b}")


def test_wrapper_checks_and_counts():
    wl = torch.arange(10, dtype=torch.int32)
    act = torch.ones(10, dtype=torch.bool)
    launches = kernel_launches("ldu_fill")
    before = launches.value
    assert kl.ldu_fill(wl, act, 4).dtype == torch.int32
    assert launches.value == before             # CPU: the plain version
    with pytest.raises(ValueError, match="unknown mode"):
        kl.ldu_fill(wl, act, 4, "x")
    with pytest.raises(ValueError, match="one \\(R,\\) shape"):
        kl.ldu_fill(wl, act[:5], 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kl.ldu_fill_cuda(wl, act, 4)
    empty = kl.ldu_fill(wl[:0], act[:0], 4)
    assert empty.dtype == torch.int32 and empty.shape == (0,)
    assert launches.value == before
