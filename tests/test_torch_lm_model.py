"""Port parity: the LM model (``models/model.py``) and the parameter and
cache converters (``interop.lm_params_from_numpy``,
``interop.decode_cache_from_numpy``) against the JAX reference, for the
four registered archs at their ``reduced()`` float32 configs (CPU).

Weights come from the reference's ``init_params`` (``jax.random``) and
reach the port through numpy; tokens come from numpy seeds. Logits and
caches agree to atol 1e-4 through the model (two layers of float32
einsums that sum in another order; measured <= 6e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models import sharding_hooks as jhooks
from repro.train import serve_step as JS
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import sharding_hooks as thooks
from repro_torch.train import serve_step as TS

ARCHS = list(ARCH_IDS)
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_hooks():
    """``set_hooks`` is process-global in both packages."""
    jhooks.set_hooks({})
    thooks.set_hooks({})
    yield
    jhooks.set_hooks({})
    thooks.set_hooks({})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    """(reference cfg, port cfg, reference params, port params, jitted
    reference forward and decode_step)."""
    jcfg = jget(request.param).reduced()
    tcfg = tget(request.param).reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.lm_params_from_numpy(jp, tcfg, device="cpu")
    fwd = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg,
                                          build_cache=True))
    dec = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    return jcfg, tcfg, jp, tp, fwd, dec


def test_forward_logits_and_caches(arch_case):
    jcfg, tcfg, jp, tp, fwd, _ = arch_case
    toks = _tokens(1, 2, 16, tcfg.vocab_size)
    jl, jaux, jc = fwd(jp, jnp.asarray(toks))
    tl, taux, tc = TM.forward(tp, {"tokens": torch.tensor(toks)}, tcfg,
                              build_cache=True)
    assert tl.shape == (2, 16, tcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    _close(taux, jaux, atol=1e-6)
    assert type(tc.kv).__name__ == type(jc.kv).__name__
    assert tc.index == int(jc.index) == 16
    for got, want in zip(tc.kv, jc.kv):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    _, _, none = TM.forward(tp, {"tokens": torch.tensor(toks)}, tcfg)
    assert none is None


def test_decode_three_steps(arch_case):
    """Prefill 12 positions, pad the cache to 20, decode 3 tokens."""
    jcfg, tcfg, jp, tp, fwd, dec = arch_case
    toks = _tokens(2, 2, 12, tcfg.vocab_size)
    _, _, jc = fwd(jp, jnp.asarray(toks))
    jc = JS._pad_cache_seq(jc, 20)
    tc = interop.decode_cache_from_numpy(jc, device="cpu")
    nxt = _tokens(3, 2, 3, tcfg.vocab_size)
    for i in range(3):
        jl, jc = dec(jp, jnp.asarray(nxt[:, i:i + 1]), jc)
        tl, tc = TM.decode_step(tp, torch.tensor(nxt[:, i:i + 1]), tc, tcfg)
        assert tl.shape == (2, 1, tcfg.vocab_size)
        _close(tl, jl)
        assert tc.index == int(jc.index) == 13 + i
    for got, want in zip(tc.kv, jc.kv):
        _close(got, want)


def test_prefill_decode_consistency(arch_case):
    """Token s logits from decode-with-cache == from the full forward
    (the reference's tests/test_archs_smoke.py, on the port); float32 on
    both paths, so atol 1e-4 (measured <= 3e-6)."""
    _, tcfg, _, tp, _, _ = arch_case
    toks = torch.tensor(_tokens(4, 2, 16, tcfg.vocab_size))
    full, _, _ = TM.forward(tp, {"tokens": toks}, tcfg)
    _, cache = TS.prefill(tp, {"tokens": toks[:, :-1]}, tcfg, max_seq=16)
    dec, cache = TS.decode(tp, toks[:, -1:], cache, tcfg)
    _close(dec[:, 0], full[:, -1].numpy())
    assert cache.index == 16


def _reference_names(jparams):
    return {name: leaf for name, leaf in interop._flatten(jparams)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_and_distributions(arch):
    """The port's parameter paths, shapes and dtypes are the reference's
    dict paths (bfloat16 here: the router stays float32); draws follow
    the reference's scales."""
    jcfg = dataclasses.replace(jget(arch).reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(tget(arch).reduced(), dtype="bfloat16")
    want = _reference_names(JM.init_params(jax.random.PRNGKey(0), jcfg))
    got = dict(TM.init_params(tcfg, seed=0, device="cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        w = np.asarray(want[name])
        assert tuple(p.shape) == w.shape, name
        assert str(p.dtype).split(".")[1] == w.dtype.name, name
        assert not p.requires_grad
        last = name.split(".")[-1]
        if last in ("ln1", "ln2", "final_norm", "q_norm", "kv_norm"):
            assert bool((p == 1).all()), name
            continue
        scale = 0.02 if last in ("embed", "router") else \
            (p.shape[0] * p.shape[1]) ** -0.5 if last == "wo" else \
            p.shape[0] ** -0.5
        std = float(p.float().std())
        assert abs(std / scale - 1) < 0.1, (name, std, scale)
    assert got["layers.0.moe.router" if tcfg.family == "moe"
               else "embed"].dtype == (torch.float32 if tcfg.family == "moe"
                                       else torch.bfloat16)


def test_init_params_is_seeded():
    cfg = tget("yi-9b").reduced()
    a = TM.init_params(cfg, seed=3, device="cpu")
    b = TM.init_params(cfg, seed=3, device="cpu")
    c = TM.init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(a.parameters(), b.parameters()))
    assert not torch.equal(a["layers"][1]["attn"]["wq"],
                           c["layers"][1]["attn"]["wq"])


@pytest.mark.parametrize("arch", ["yi-9b", "moonshot-v1-16b-a3b"])
def test_converter_takes_both_layer_layouts(arch):
    """A stacked tree (``scan_layers=True``, leaves (L, ...)) and the
    same layers as a list (``scan_layers=False``) load to equal
    parameters; the stacked model's forward equals the reference's scan."""
    jcfg = dataclasses.replace(jget(arch).reduced(), scan_layers=True)
    tcfg = dataclasses.replace(tget(arch).reduced(), scan_layers=True)
    jp = JM.init_params(jax.random.PRNGKey(5), jcfg)
    assert isinstance(jp["layers"], dict)
    listed = dict(jp, layers=[
        jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
        for i in range(jcfg.num_layers)])
    a = interop.lm_params_from_numpy(jp, tcfg, device="cpu")
    b = interop.lm_params_from_numpy(listed, tcfg, device="cpu")
    assert [n for n, _ in a.named_parameters()] == \
        [n for n, _ in b.named_parameters()]
    assert all(torch.equal(x, y) for x, y in
               zip(a.parameters(), b.parameters()))
    toks = _tokens(6, 2, 8, tcfg.vocab_size)
    jl, _, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, _, _ = TM.forward(a, {"tokens": torch.tensor(toks)}, tcfg)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ["yi-9b", "moonshot-v1-16b-a3b"])
def test_converter_keeps_bfloat16_and_float32_router(arch):
    jcfg = dataclasses.replace(jget(arch).reduced(), dtype="bfloat16",
                               scan_layers=True)
    tcfg = dataclasses.replace(tget(arch).reduced(), dtype="bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(6), jcfg)
    tp = interop.lm_params_from_numpy(jp, tcfg, device="cpu")
    want = _reference_names(dict(jp, layers=[
        jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
        for i in range(jcfg.num_layers)]))
    for name, p in tp.named_parameters():
        w = np.asarray(want[name])
        expect = torch.float32 if name.endswith("router") \
            else torch.bfloat16
        assert p.dtype == expect, name
        assert w.dtype.name == str(expect).split(".")[1], name
        # bfloat16 -> float32 -> bfloat16 is exact
        np.testing.assert_array_equal(p.float().numpy(),
                                      w.astype(np.float32), name)


def test_converter_rejects_a_mismatched_tree():
    jcfg, tcfg = jget("yi-9b").reduced(), tget("yi-9b").reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    missing = dict(jp)
    del missing["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        interop.lm_params_from_numpy(missing, tcfg, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        interop.lm_params_from_numpy(
            jp, dataclasses.replace(tcfg, d_ff=128), device="cpu")


def test_cache_converter_round_trip():
    cfg = jget("minicpm3-4b").reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    _, _, jc = JM.forward(jp, {"tokens": jnp.ones((1, 4), jnp.int32)}, cfg,
                          build_cache=True)
    tc = interop.decode_cache_from_numpy(jc, device="cpu")
    assert isinstance(tc.kv, TL.MLACache) and tc.index == 4
    back = interop.to_numpy(tc)
    assert isinstance(back, TM.DecodeCache) and back.ssm is None
    for got, want in zip(back.kv, jc.kv):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_init_cache_layout_equals_reference():
    for arch in ("yi-9b", "minicpm3-4b"):
        jc = JM.init_cache(jget(arch).reduced(), 3, 24)
        tc = TM.init_cache(tget(arch).reduced(), 3, 24, device="cpu")
        assert type(tc.kv).__name__ == type(jc.kv).__name__
        assert [tuple(a.shape) for a in tc.kv] == [a.shape for a in jc.kv]
        assert tc.index == int(jc.index) == 0


def test_unknown_family_raises():
    """Every family of the reference runs (``test_torch_lm_families.py``);
    a family that is none of them is refused."""
    cfg = dataclasses.replace(tget("yi-9b").reduced(), family="rnn")
    for call in (lambda: TM.init_params(cfg, device="cpu"),
                 lambda: TM.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: TM.forward(None, {"tokens": torch.ones(1, 2)}, cfg),
                 lambda: TM.decode_step(None, torch.ones(1, 1), None, cfg)):
        with pytest.raises(NotImplementedError, match="'rnn'"):
            call()
