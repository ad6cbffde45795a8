"""Port parity: the train step (``train/train_step.py``), remat
(``models/model.py``) and ``interop.train_state_from_numpy`` against the
JAX reference, on ``reduced()`` float32 configs (CPU).

Weights and moments come from the reference's ``init_train_state``
through ``interop.train_state_from_numpy``; batches are the reference's
``batch_at``. The reference's loss and gradient are
``jax.value_and_grad(make_loss_fn(cfg))``, jitted.

Tolerances (float32, two layers that sum in another order):
  - loss and aux loss: atol 1e-5 (measured <= 1e-6);
  - gradients: each leaf within 2e-5 x its max|g| (measured <= 2.4e-6);
  - three AdamW steps (lr 1e-3 from a warm-up of 1): the update is
    ~lr mh / sqrt(vh), which turns a gradient's relative error into the
    update's, so where |g| < G_FLOOR x the leaf's max|g| a gradient that
    differs in its last bits may move the update by a good part of lr, or
    flip its sign. Elements above the floor at every step agree to
    P_GATE x lr (measured <= 3.4e-4 lr); the rest are counted (at most
    REST_SHARE of all elements past P_GATE x lr; measured <= 1.4e-4) and
    bounded by 2 lr a step (measured <= 0.09 lr). The moments agree to
    M_RTOL x their leaf's max (measured <= 2.7e-5); loss and aux loss to
    atol 1e-5, the grad norm to rtol 1e-5 (measured <= 9e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.models import sharding_hooks as jhooks
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import sharding_hooks as thooks
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT

ARCHS = list(ARCH_IDS)
G_RTOL = 2e-5
G_FLOOR = 1e-2
P_GATE = 1e-3
REST_SHARE = 1e-3
M_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_hooks():
    """``set_hooks`` is process-global in both packages."""
    jhooks.set_hooks({})
    thooks.set_hooks({})
    yield
    jhooks.set_hooks({})
    thooks.set_hooks({})


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch).reduced(), **kw),
            dataclasses.replace(tget(arch).reduced(), **kw))


def _states(jcfg, tcfg, seed=0):
    js = JT.init_train_state(jax.random.PRNGKey(seed), jcfg)
    return js, interop.train_state_from_numpy(js.params, js.opt, tcfg,
                                              device="cpu")


def _batch(vocab, step=0, b=2, s=32, seed=1):
    jb = JD.batch_at(JD.DataConfig(batch_size=b, seq_len=s, vocab_size=vocab,
                                   seed=seed), step)
    return jb, {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}


def _port_grads(tcfg, params, batch):
    named = dict(params.named_parameters())
    total, metrics = TT.make_loss_fn(tcfg)(params, batch)
    grads = torch.autograd.grad(total, list(named.values()))
    return total, metrics, dict(zip(named, grads))


def _leaf_close(got, want, rtol):
    """Each leaf of ``got`` (port names) within rtol x max|want|."""
    assert set(got) == set(want)
    for k, g in got.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max(), err_msg=k)


def test_cross_entropy_parity():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        got = TT.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                               None if m is None else torch.tensor(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bfloat16 logits: the CE is taken in float32
    got = TT.cross_entropy(torch.tensor(logits).bfloat16(),
                           torch.tensor(labels))
    assert got.dtype == torch.float32


# (arch, config overrides, sequence length). moonshot at 288 positions
# with capacity factor 0.5: 576 (token, expert) pairs a row, past the
# dropless threshold (512), into 36 slots for each of 8 experts, so the
# capped dispatch drops about half of them.
GRAD_CASES = {arch: (arch, {}, 32) for arch in ARCHS}
GRAD_CASES["moe_drops"] = ("moonshot-v1-16b-a3b",
                           dict(moe_capacity_factor=0.5), 288)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_gradients(case):
    arch, kw, s = GRAD_CASES[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    if case == "moe_drops":
        assert L.row_capacity(tcfg, s) * tcfg.num_experts \
            < s * tcfg.experts_per_token
    js, ts = _states(jcfg, tcfg)
    jb, tb = _batch(tcfg.vocab_size, s=s)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jcfg), has_aux=True))(js.params, jb)
    total, m, grads = _port_grads(tcfg, ts.params, tb)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               atol=1e-5)
    np.testing.assert_allclose(float(m["loss"].detach()), float(jm["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(m["aux_loss"].detach()),
                               float(jm["aux_loss"]),
                               atol=1e-5)
    _leaf_close(grads, interop._named_leaves(jg, tcfg), G_RTOL)


def _check_params(ts, js, big, lr, steps, tcfg):
    want = interop._named_leaves(js.params, tcfg)
    n_rest = n_over = 0
    for k, p in ts.params.named_parameters():
        d = np.abs(p.detach().numpy() - np.asarray(want[k]))
        assert d[big[k]].max(initial=0) <= P_GATE * lr, k
        rest = d[~big[k]]
        assert rest.max(initial=0) <= 2 * lr * steps, k
        n_rest += rest.size
        n_over += int((rest > P_GATE * lr).sum())
    assert n_over <= REST_SHARE * sum(
        p.numel() for p in ts.params.parameters()), (n_over, n_rest)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps(arch):
    """Metrics, parameters, mu and nu after each of three steps."""
    jcfg, tcfg = _cfgs(arch)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(JT.make_train_step(jcfg, JO.OptimizerConfig(**kw)))
    jgrad = jax.jit(jax.grad(lambda p, b: JT.make_loss_fn(jcfg)(p, b)[0]))
    tstep = TT.make_train_step(tcfg, TO.OptimizerConfig(**kw))
    js, ts = _states(jcfg, tcfg)
    big = None
    for i in range(3):
        jb, tb = _batch(tcfg.vocab_size, step=i)
        g = interop._named_leaves(jgrad(js.params, jb), tcfg)
        mask = {k: np.abs(np.asarray(v)) >= G_FLOOR * np.abs(v).max()
                for k, v in g.items()}
        big = mask if big is None else {k: big[k] & mask[k] for k in big}
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert tm["step"] == int(jm["step"]) == ts.opt.step == i + 1
        for k in ("loss", "aux_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        _check_params(ts, js, big, float(jm["lr"]), i + 1, tcfg)
        _leaf_close(ts.opt.mu, interop._named_leaves(js.opt.mu, tcfg),
                    M_RTOL)
        _leaf_close(ts.opt.nu, interop._named_leaves(js.opt.nu, tcfg),
                    M_RTOL)


class _BackwardOps(TorchDispatchMode):
    """Counts the operations run (all, and the products with no batch
    dimension, which ``torch.einsum`` lowers to a ``bmm`` of batch 1)."""

    def __init__(self):
        super().__init__()
        self.ops = self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.dots += func is torch.ops.aten.bmm.default \
            and args[0].shape[0] == 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_agree(arch):
    """"full" and "dots" give "none"'s loss and gradients (bit for bit on
    the CPU). In the backward "full" runs each block again (the weight
    products too); "dots" runs again all but the weight products, which
    it kept; "none" runs nothing again."""
    _, base = _cfgs(arch)
    params = TM.init_params(base, seed=0, device="cpu").requires_grad_()
    _, tb = _batch(base.vocab_size)
    out, ran = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        named = dict(params.named_parameters())
        total, _ = TT.make_loss_fn(cfg)(params, tb)
        with _BackwardOps() as ops:
            grads = torch.autograd.grad(total, list(named.values()))
        out[remat] = total.detach(), dict(zip(named, grads))
        ran[remat] = ops.ops, ops.dots
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for k, g in out["none"][1].items():
            assert torch.equal(out[remat][1][k], g), (remat, k)
    assert ran["none"][0] < ran["dots"][0] < ran["full"][0], ran
    assert ran["none"][1] == ran["dots"][1] < ran["full"][1], ran

    calls = []
    real = TM._apply_block

    def spy(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    cfg = dataclasses.replace(base, remat="full")
    try:
        TM._apply_block = spy
        total, _ = TT.make_loss_fn(cfg)(params, tb)
        n_fwd = len(calls)
        torch.autograd.grad(total, list(params.parameters()))
    finally:
        TM._apply_block = real
    assert n_fwd == len(calls) - n_fwd == base.num_layers


def test_remat_only_where_autograd_records():
    """Decode, ``torch.no_grad()`` and parameters without gradients (the
    serving path) run the blocks plainly."""
    cfg = dataclasses.replace(tget("yi-9b").reduced(), remat="full")
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    real = TM._maybe_remat
    used = []
    try:
        TM._maybe_remat = lambda fn, c: used.append(c) or real(fn, c)
        TM.forward(params, toks, cfg)
        params.requires_grad_()
        with torch.no_grad():
            TM.forward(params, toks, cfg)
        assert not used
        TM.forward(params, toks, cfg)
        assert len(used) == 1
    finally:
        TM._maybe_remat = real


def test_mesh_is_not_ported():
    """The mesh is ported (``tests/test_torch_dist_train.py``); what is
    not a ``DeviceMesh`` is refused."""
    cfg = tget("yi-9b").reduced()
    with pytest.raises(TypeError, match="DeviceMesh"):
        TT.make_train_step(cfg, TO.OptimizerConfig(), mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        TT.make_loss_fn(cfg, mesh=object())


def test_train_state_from_numpy_layouts_and_checks():
    """Either layer layout; moments must match the parameters."""
    jcfg, tcfg = _cfgs("minicpm3-4b")
    js, ts = _states(jcfg, tcfg)
    stacked = dataclasses.replace(jcfg, scan_layers=True)
    js2 = JT.init_train_state(jax.random.PRNGKey(0), stacked)
    ts2 = interop.train_state_from_numpy(js2.params, js2.opt, tcfg,
                                         device="cpu")
    for (k, a), (_, b) in zip(ts.params.named_parameters(),
                              ts2.params.named_parameters()):
        assert a.requires_grad and torch.equal(a, b), k
    assert ts.opt.step == 0 and list(ts.opt.mu) == list(ts.opt.nu) == [
        k for k, _ in ts.params.named_parameters()]
    bad = js.opt._replace(mu=dict(js.opt.mu, embed=np.zeros((3, 3),
                                                            np.float32)))
    with pytest.raises(ValueError, match="embed"):
        interop.train_state_from_numpy(js.params, bad, tcfg, device="cpu")
