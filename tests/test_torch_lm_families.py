"""Port parity: the ssm, hybrid, encdec and vlm families of the LM model
(``models/model.py``), ``interop``'s converters for their parameters and
caches, and ``serve_step``'s refusals, against the JAX reference, at the
``reduced()`` float32 forms of the four configs in
``_torch_family_configs`` (CPU).

Weights come from the reference's ``init_params`` (``jax.random``)
through ``interop.lm_params_from_numpy``; tokens, encoder frames and
vision embeddings from numpy seeds. Prompts are 64 tokens, so the
reduced ``ssm_chunk`` of 32 gives two chunks and the inter-chunk loop
runs; the reduced hybrid has 7 layers, 3 groups of 2 plus a tail of 1.

Tolerance: logits and every cache field agree to atol 1e-4, as in
``test_torch_lm_model.py`` (float32 einsums that sum in another order,
the SSD's pairwise products among them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_configs import FAMILY_CONFIGS
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import model as JM
from repro.models import sharding_hooks as jhooks
from repro.train import serve_step as JS
from repro_torch import interop
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import sharding_hooks as thooks
from repro_torch.train import serve_step as TS

NAMES = sorted(FAMILY_CONFIGS)
ATOL = 1e-4
B, S = 2, 64


@pytest.fixture(autouse=True)
def _reset_hooks():
    """``set_hooks`` is process-global in both packages."""
    jhooks.set_hooks({})
    thooks.set_hooks({})
    yield
    jhooks.set_hooks({})
    thooks.set_hooks({})


def _cfgs(name, **kw):
    fields = FAMILY_CONFIGS[name]
    return (dataclasses.replace(JArchConfig(**fields).reduced(), **kw),
            dataclasses.replace(TArchConfig(**fields).reduced(), **kw))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _inputs(cfg, seed, b=B, s=S):
    """Numpy tokens, and the stub frontends' frames or vision embeddings
    where the family takes them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.family == "vlm":
        out["vision"] = rng.normal(
            size=(b, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """(reference cfg, port cfg, reference params, port params, jitted
    reference forward with cache and decode_step)."""
    jcfg, tcfg = _cfgs(request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.lm_params_from_numpy(jp, tcfg, device="cpu")
    fwd = jax.jit(lambda p, bt: JM.forward(p, bt, jcfg, build_cache=True))
    dec = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    return jcfg, tcfg, jp, tp, fwd, dec


def _assert_cache(got, want):
    """Every field of the port's ``DecodeCache`` against the reference's:
    None where it is None, else its type, shapes and values."""
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if name == "index":
            assert g == int(w), name
        elif w is None:
            assert g is None, name
        elif isinstance(w, tuple):
            assert type(g).__name__ == type(w).__name__, name
            for a, b in zip(g, w):
                assert tuple(a.shape) == b.shape, name
                _close(a, b)
        else:
            assert tuple(g.shape) == w.shape, name
            _close(g, w)


def test_forward_logits_aux_and_cache(case):
    jcfg, tcfg, jp, tp, fwd, _ = case
    if tcfg.family in ("ssm", "hybrid"):
        assert S // tcfg.ssm_chunk == 2
    jb, tb = _both(_inputs(tcfg, 1))
    jl, jaux, jc = fwd(jp, jb)
    tl, taux, tc = TM.forward(tp, tb, tcfg, build_cache=True)
    assert tl.shape == (B, S, tcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    _close(taux, jaux, atol=1e-6)
    _assert_cache(tc, jc)
    offset = tcfg.num_vision_tokens if tcfg.family == "vlm" else 0
    assert tc.index == S + offset
    _, _, none = TM.forward(tp, tb, tcfg)
    assert none is None


def test_decode_steps(case):
    """Three decode steps from the reference's own cache: the forward's
    (its kv padded), or ``init_cache``'s for hybrid, whose forward cache
    holds the shared block's K/V under ``kv``. encdec runs through the
    forward's ``cross_kv`` and again without it (``kv_x=enc_out``)."""
    jcfg, tcfg, jp, tp, fwd, dec = case
    batch = _inputs(tcfg, 2)
    if tcfg.family == "hybrid":
        starts = [JM.init_cache(jcfg, B, 16)]
    else:
        _, _, jc = fwd(jp, _both(batch)[0])
        jc = JS._pad_cache_seq(jc, int(jc.index) + 8)
        starts = [jc] + ([jc._replace(cross_kv=None)]
                         if tcfg.family == "encdec" else [])
    nxt = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, 3))
    for jc in starts:
        tc = interop.decode_cache_from_numpy(jc, device="cpu")
        for i in range(3):
            jl, jc = dec(jp, jnp.asarray(nxt[:, i:i + 1], jnp.int32), jc)
            tl, tc = TM.decode_step(tp, torch.tensor(nxt[:, i:i + 1]), tc,
                                    tcfg)
            assert tl.shape == (B, 1, tcfg.vocab_size)
            _close(tl, jl)
        _assert_cache(tc, jc)


def test_cache_converter_round_trip(case):
    """The forward's and ``init_cache``'s caches through
    ``decode_cache_from_numpy`` and back, bit for bit."""
    jcfg, tcfg, jp, _, fwd, _ = case
    jb, _ = _both(_inputs(tcfg, 4))
    _, _, jc = fwd(jp, jb)
    enc = jc.enc_out
    for want in (jc, JM.init_cache(jcfg, B, 24, enc_out=enc)):
        tc = interop.decode_cache_from_numpy(want, device="cpu")
        if want.ssm is not None:
            assert isinstance(tc.ssm, TL.SSMState)
        back = interop.to_numpy(tc)
        assert isinstance(back, TM.DecodeCache)
        for name in want._fields:
            w, g = getattr(want, name), getattr(back, name)
            if w is None or name == "index":
                assert g == (None if w is None else int(w)), name
                continue
            for a, b in zip(*((g, w) if isinstance(w, tuple)
                              else ((g,), (w,)))):
                np.testing.assert_array_equal(a, np.asarray(b), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_layout_equals_reference(case, dtype):
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in case[:2])
    for kw in ({}, {"with_cross_kv": False}):
        jc = JM.init_cache(jcfg, 3, 24, **kw)
        tc = TM.init_cache(tcfg, 3, 24, device="cpu", **kw)
        for name in jc._fields:
            w, g = getattr(jc, name), getattr(tc, name)
            if name == "index":
                assert g == int(w) == 0
            elif w is None:
                assert g is None, name
            else:
                assert type(g).__name__ == type(w).__name__, name
                assert [(tuple(a.shape), str(a.dtype).split(".")[1])
                        for a in g] == [(a.shape, a.dtype.name) for a in w]


def test_init_params_layout_equals_reference(case):
    """The port's parameter names, shapes and dtypes are the reference's
    dict paths, with ``layers`` and ``encoder`` unstacked; norms,
    ``d_skip`` at one, ``conv_b``, ``a_log``, ``dt_bias`` at zero."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in case[:2])
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    want = interop._named_leaves(jp, tcfg)
    got = dict(TM.init_params(tcfg, seed=0, device="cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        w = np.asarray(want[name])
        assert tuple(p.shape) == w.shape, name
        assert str(p.dtype).split(".")[1] == w.dtype.name, name
        last = name.split(".")[-1]
        if last in ("a_log", "d_skip", "dt_bias", "conv_b") or \
                last.startswith("ln") or last.endswith("norm"):
            np.testing.assert_array_equal(p.float().numpy(),
                                          w.astype(np.float32), name)


def test_serve_step_refusals(case):
    """``greedy_generate`` refuses the four families, ``prefill`` the
    hybrid one, with the reference's messages; the others prefill as the
    reference does."""
    jcfg, tcfg, jp, tp, _, _ = case
    jb, tb = _both(_inputs(tcfg, 5, s=32))
    jprefill = jax.jit(lambda p, b: JS.prefill(p, b, jcfg, max_seq=64))
    for call in (lambda: TS.greedy_generate(tp, tb["tokens"], tcfg,
                                            max_new=2, max_seq=40),
                 lambda: JS.greedy_generate(jp, jb["tokens"], jcfg,
                                            max_new=2, max_seq=40)):
        with pytest.raises(NotImplementedError, match="decoder-only"):
            call()
    if tcfg.family == "hybrid":
        for call in (lambda: TS.prefill(tp, tb, tcfg, max_seq=64),
                     lambda: jprefill(jp, jb)):
            with pytest.raises(NotImplementedError, match="hybrid prefill"):
                call()
        return
    _, tc = TS.prefill(tp, tb, tcfg, max_seq=64)
    _, jc = jprefill(jp, jb)
    _assert_cache(tc, jc)


def test_pad_cache_seq_pads_shared_kv():
    jcfg, tcfg = _cfgs("zamba2-7b")
    jc = JM.init_cache(jcfg, 2, 16)
    want = JS._pad_cache_seq(jc, 24)
    got = TS._pad_cache_seq(interop.decode_cache_from_numpy(jc, device="cpu"),
                            24)
    assert got.shared_kv.k.shape[3] == 24
    _assert_cache(got, want)
