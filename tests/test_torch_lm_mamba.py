"""Port parity: the Mamba2 mixer (``layers.mamba2_mix``, ``_segsum``,
``_softplus``) against the JAX reference's, and one train step of the
reduced ssm and encdec configs against the reference's, on float32
(CPU).

The mixer's weights come from the reference's ``init_mamba2`` with its
decay, step, skip and conv-bias parameters redrawn from numpy seeds (the
reference initialises them to constants, which would leave the decays
all equal); inputs from numpy seeds. At the reduced width (d_inner 256,
8 heads of 32, state 16, ``ssm_chunk`` 32) outputs and states agree to
atol 1e-5 (float32 sums in another order: the reference's four-operand
einsums are pairwise products here). The train step is held as
``test_torch_train_step.py`` holds the registered configs': loss and
grad norm, the parameters by the Adam rule, the moments; it runs the
backward through the chunked SSD (two chunks) and the cross-attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_configs import FAMILY_CONFIGS
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import layers as JL
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import interop
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import layers as TL
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT
from test_torch_train_step import G_FLOOR, M_RTOL, _check_params, _leaf_close

ATOL = 1e-5
B = 2


def _cfgs(name="mamba2-780m"):
    fields = FAMILY_CONFIGS[name]
    return JArchConfig(**fields).reduced(), TArchConfig(**fields).reduced()


@pytest.fixture(scope="module")
def mixer():
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = _cfgs()
    p = dict(JL.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rng = np.random.default_rng(0)
    h = tcfg.ssm_heads
    p["a_log"] = rng.normal(size=h).astype(np.float32) * 0.5
    p["dt_bias"] = rng.normal(size=h).astype(np.float32)
    p["d_skip"] = rng.normal(size=h).astype(np.float32)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32) * .1
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    return jcfg, tcfg, jp, tp


def _x(seed, s, d=128):
    return np.random.default_rng(seed).normal(size=(B, s, d)).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _state(jstate):
    """A reference ``SSMState`` as the port's (copies: the port writes a
    given state in place)."""
    return TL.SSMState(*(torch.tensor(np.array(a)) for a in jstate))


def _jmix(jcfg, **kw):
    return jax.jit(lambda p, x, st=None: JL.mamba2_mix(p, x, jcfg, state=st,
                                                       **kw))


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_prefill_from_zeros(mixer, chunks):
    jcfg, tcfg, jp, tp = mixer
    x = _x(chunks, chunks * tcfg.ssm_chunk)
    want, jst = _jmix(jcfg, return_state=True)(jp, jnp.asarray(x))
    got, tst = TL.mamba2_mix(tp, torch.tensor(x), tcfg, return_state=True)
    _close(got, want)
    assert tst.h.dtype == torch.float32
    _close(tst.h, jst.h)
    _close(tst.conv, jst.conv)
    none = TL.mamba2_mix(tp, torch.tensor(x), tcfg)[1]
    assert none is None


def test_prefill_continuing_a_state(mixer):
    """The ``s > 1`` branch with a state: the conv pads from
    ``state.conv`` and the scan starts from ``state.h``; the given state
    is updated in place."""
    jcfg, tcfg, jp, tp = mixer
    first, more = _x(4, 64), _x(5, 2 * tcfg.ssm_chunk)
    _, jst = _jmix(jcfg, return_state=True)(jp, jnp.asarray(first))
    want, jst2 = _jmix(jcfg, return_state=True)(jp, jnp.asarray(more), jst)
    st = _state(jst)
    got, tst2 = TL.mamba2_mix(tp, torch.tensor(more), tcfg, state=st)
    assert tst2 is st
    _close(got, want)
    _close(st.h, jst2.h)
    _close(st.conv, jst2.conv)


def test_decode_steps(mixer):
    """Three one-token steps from a prefilled state, in place, against the
    reference's; and the same tokens through the continuing prefill give
    the steps' outputs (one recurrence, two orders of sums)."""
    jcfg, tcfg, jp, tp = mixer
    _, jst = _jmix(jcfg, return_state=True)(jp, jnp.asarray(_x(6, 32)))
    st = _state(jst)
    start = _state(jst)
    toks = _x(7, 3)
    jdec = _jmix(jcfg)
    outs = []
    for i in range(3):
        want, jst = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jst)
        got, st2 = TL.mamba2_mix(tp, torch.tensor(toks[:, i:i + 1]), tcfg,
                                 state=st)
        assert st2 is st
        _close(got, want)
        _close(st.h, jst.h)
        _close(st.conv, jst.conv)
        outs.append(got)
    q = dataclasses.replace(tcfg, ssm_chunk=1)
    whole, _ = TL.mamba2_mix(tp, torch.tensor(toks), q, state=start)
    _close(whole, torch.cat(outs, 1).numpy())
    _close(start.h, st.h.numpy())


def test_chunk_must_divide(mixer):
    jcfg, tcfg, jp, tp = mixer
    x = _x(8, 48)
    with pytest.raises(AssertionError, match="divisible by ssm_chunk"):
        TL.mamba2_mix(tp, torch.tensor(x), tcfg)
    with pytest.raises(AssertionError, match="divisible by ssm_chunk"):
        JL.mamba2_mix(jp, jnp.asarray(x), jcfg)


def test_chunk_size_does_not_change_the_result(mixer):
    """The chunked SSD at chunks of 32, 16 and 8 (and 64: one chunk)."""
    _, tcfg, _, tp = mixer
    x = torch.tensor(_x(9, 64))
    want, wst = TL.mamba2_mix(tp, x, tcfg, return_state=True)
    for q in (8, 16, 64):
        got, gst = TL.mamba2_mix(tp, x, dataclasses.replace(
            tcfg, ssm_chunk=q), return_state=True)
        _close(got, want.numpy())
        _close(gst.h, wst.h.numpy())


def test_segsum_and_its_gradient():
    a = np.random.default_rng(10).normal(size=(2, 3, 16)).astype(
        np.float32)
    want = JL._segsum(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    got = TL._segsum(ta)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    assert bool(torch.isinf(got).sum() == 2 * 3 * 16 * 15 // 2)
    # exp after the mask: zero above the diagonal, a finite gradient
    torch.exp(got).sum().backward()
    assert bool(torch.isfinite(ta.grad).all())
    # the gradient sums terms up to ~1e2 that cancel to ~0 in places:
    # held to 1e-6 x its largest element
    jg = np.asarray(jax.grad(lambda v: jnp.exp(JL._segsum(v)).sum())(
        jnp.asarray(a)))
    np.testing.assert_allclose(ta.grad.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())


def test_softplus_is_jax_softplus():
    """No switch to the identity past 20 (``F.softplus``'s threshold)."""
    x = np.array([-40.0, -3.0, 0.0, 1.5, 19.9, 20.0, 20.5, 35.0, 90.0],
                 np.float32)
    np.testing.assert_allclose(TL._softplus(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("name", ["mamba2-780m", "whisper-large-v3"])
def test_one_train_step(name):
    """One AdamW step of the reduced config from the reference's state;
    64 positions (two SSD chunks) with the encoder frames for whisper."""
    jcfg, tcfg = _cfgs(name)
    js = JT.init_train_state(jax.random.PRNGKey(1), jcfg)
    ts = interop.train_state_from_numpy(js.params, js.opt, tcfg,
                                        device="cpu")
    jb = dict(JD.batch_at(JD.DataConfig(batch_size=B, seq_len=64,
                                        vocab_size=tcfg.vocab_size, seed=2),
                          0))
    if tcfg.family == "encdec":
        jb["frames"] = jnp.asarray(np.random.default_rng(3).normal(
            size=(B, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32))
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    g = interop._named_leaves(jax.jit(jax.grad(
        lambda p, b: JT.make_loss_fn(jcfg)(p, b)[0]))(js.params, jb), tcfg)
    big = {k: np.abs(np.asarray(v)) >= G_FLOOR * np.abs(v).max()
           for k, v in g.items()}
    js, jm = jax.jit(JT.make_train_step(jcfg, JO.OptimizerConfig(**kw)))(
        js, jb)
    ts, tm = TT.make_train_step(tcfg, TO.OptimizerConfig(**kw))(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _check_params(ts, js, big, float(jm["lr"]), 1, tcfg)
    _leaf_close(ts.opt.mu, interop._named_leaves(js.opt.mu, tcfg), M_RTOL)
    _leaf_close(ts.opt.nu, interop._named_leaves(js.opt.nu, tcfg), M_RTOL)
