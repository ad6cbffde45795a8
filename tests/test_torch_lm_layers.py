"""Port parity: the LM layers (``models/layers.py``) against the JAX
reference, on ``reduced()`` float32 configs (CPU).

Weights come from the reference's ``init_*`` (``jax.random``) and inputs
from numpy seeds; both pass to torch through numpy. Every layer output
agrees to atol 1e-5 (float32 einsums over widths <= 256 that sum in
another order; measured <= 4e-6). MoE outputs reach |y| ~ 240, because
the reference draws expert weights at 1/sqrt(E), and cancel in the
combine: they are held to 2e-6 x max|y| (measured <= 4.5e-7 x max|y|).
The places where a port is likely to
drift are each named in a test: the tanh GELU, RoPE's split halves, the
flash chunking and its auto switch, the MoE capacity rules, its stable
sort and run starts, and its drops."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import sharding_hooks as jhooks
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as FK
from repro_torch.models import layers as TL
from repro_torch.models import sharding_hooks as thooks

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_hooks():
    """``set_hooks`` is process-global in both packages."""
    jhooks.set_hooks({})
    thooks.set_hooks({})
    yield
    jhooks.set_hooks({})
    thooks.set_hooks({})


def _set_flags(**flags):
    jhooks.set_hooks(flags)
    thooks.set_hooks(flags)


def _cfgs(arch, **overrides):
    j = dataclasses.replace(jget(arch).reduced(), **overrides)
    t = dataclasses.replace(tget(arch).reduced(), **overrides)
    return j, t


def _jit(fn, **static):
    """The reference's ``fn`` jitted with ``static`` bound (ten times
    faster than op-by-op on the CPU). A new closure each call, so a trace
    never outlives the hooks it read."""
    return jax.jit(lambda *args: fn(*args, **static))


def _t(tree):
    """A reference param dict (or array) as torch tensors, through numpy."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _positions(b, s, start=0):
    p = np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s))
    return jnp.asarray(p), torch.tensor(np.ascontiguousarray(p))


# --- norms / rope ----------------------------------------------------------

def test_rmsnorm():
    x, scale = _rand(0, 2, 5, 64), _rand(1, 64)
    _close(TL.rmsnorm(torch.tensor(scale), torch.tensor(x), 1e-5),
           JL.rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-5))


def test_rmsnorm_bfloat16_keeps_dtype():
    x, scale = _rand(2, 3, 64), _rand(3, 64)
    got = TL.rmsnorm(torch.tensor(scale).bfloat16(),
                     torch.tensor(x).bfloat16())
    want = JL.rmsnorm(jnp.asarray(scale, jnp.bfloat16),
                      jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bfloat16 ulp (2^-8 relative) where float32 sums round apart
    _close(got.float(), np.asarray(want, np.float32), atol=1e-6,
           rtol=2 ** -8)


@pytest.mark.parametrize("theta", [1e4, 1e5])
def test_rope_parity(theta):
    x = _rand(4, 2, 7, 3, 32)
    jp, tp = _positions(2, 7, start=5)
    _close(TL.rope_freqs(32, theta), JL.rope_freqs(32, theta), atol=0,
           rtol=1e-6)
    assert TL.rope_freqs(32, theta).dtype == torch.float32
    _close(TL.apply_rope(torch.tensor(x), tp, theta),
           JL.apply_rope(jnp.asarray(x), jp, theta))


def test_rope_rotates_split_halves():
    """RoPE pairs x[..., i] with x[..., i + K/2] (split halves), not
    x[..., 2i] with x[..., 2i + 1] (interleaved)."""
    k, theta = 8, 1e4
    x = _rand(5, 1, 3, 1, k)
    pos = np.array([[0, 1, 7]])
    ang = pos[..., None] * (1.0 / theta ** (np.arange(0, k, 2) / k))
    cos, sin = np.cos(ang)[:, :, None], np.sin(ang)[:, :, None]
    x1, x2 = x[..., :k // 2], x[..., k // 2:]
    halves = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    xe, xo = x[..., 0::2], x[..., 1::2]
    inter = np.stack([xe * cos - xo * sin, xe * sin + xo * cos], -1
                     ).reshape(x.shape)
    got = TL.apply_rope(torch.tensor(x), torch.tensor(pos), theta).numpy()
    _close(got, halves)
    assert np.abs(got - inter).max() > 0.1


# --- attention cores -------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_sdpa_parity(masked):
    b, s, t, g, hq, d = 2, 6, 9, 2, 3, 16
    q, k, v = _rand(6, b, s, g, hq, d), _rand(7, b, g, t, d), \
        _rand(8, b, g, t, d)
    m = (np.arange(t)[None, :] <= np.arange(s)[:, None] + 3)[None, None,
                                                             None]
    got = TL._sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                   torch.tensor(m) if masked else None)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(m) if masked else None)
    _close(got, want)


# (b, s, t, g, hq, d, dv, causal, q_chunk, kv_chunk, causal_skip)
FLASH_CASES = {
    "causal": (2, 128, 128, 2, 2, 32, 32, True, 32, 64, False),
    "full": (2, 128, 128, 2, 2, 32, 32, False, 32, 64, False),
    "one_kv_group": (1, 256, 256, 1, 4, 64, 64, True, 32, 64, False),
    "causal_skip": (1, 256, 256, 2, 2, 32, 32, True, 64, 64, True),
    # q chunks finer than kv chunks: the reference's loop runs past the
    # last kv chunk (a clamped, fully masked read)
    "causal_skip_q_finer": (1, 256, 256, 2, 2, 32, 32, True, 32, 64, True),
    # non-dividing lengths fall back to one block
    "non_dividing": (1, 96, 96, 1, 2, 16, 16, True, 64, 64, False),
    # rectangular (s != t): causal_skip is ignored
    "rect_causal_skip": (1, 64, 128, 2, 2, 16, 16, True, 32, 32, True),
    "rect_full": (2, 64, 192, 1, 2, 16, 16, False, 32, 64, False),
    # MLA's layout: per-head keys (g = h, hq = 1), value dim != key dim
    "mla_layout": (1, 128, 128, 4, 1, 40, 24, True, 32, 64, True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_parity(case):
    b, s, t, g, hq, d, dv, causal, qc, kc, skip = FLASH_CASES[case]
    q = _rand(9, b, s, g, hq, d, scale=0.5)
    k = _rand(10, b, g, t, d, scale=0.5)
    v = _rand(11, b, g, t, dv, scale=0.5)
    kw = dict(causal=causal, scale=1.0 / d ** 0.5, q_chunk=qc, kv_chunk=kc,
              causal_skip=skip)
    got = TL.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), **kw)
    want = _jit(JL.flash_attention, **kw)(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    assert tuple(got.shape) == (b, s, g, hq, dv)
    _close(got, want)
    # ... and the online softmax equals the materialized one (the
    # reference's own tolerance, tests/test_flash_attention.py).
    mask = None
    if causal:
        mask = torch.tensor(np.arange(t)[None, :] <= np.arange(s)[:, None]
                            )[None, None, None]
    dense = TL._sdpa(torch.tensor(q) * (d ** 0.5 * kw["scale"]),
                     torch.tensor(k), torch.tensor(v), mask)
    _close(got, dense.numpy(), atol=2e-5, rtol=1e-4)


# --- the flash kernel: its dispatch and the plain models of its arithmetic --

# where, dtype, key width, value width, and the word of the refusal
DISPATCH_CASES = {
    "cpu_bf16_compiled_widths": ("cpu", torch.bfloat16, 96, 64, "devices"),
    "cpu_float32": ("cpu", torch.float32, 96, 64, "dtypes"),
    "cpu_float64": ("cpu", torch.float64, 128, 128, "dtypes"),
    "cpu_bf16_other_widths": ("cpu", torch.bfloat16, 40, 24, "widths"),
    "fake_cuda_bf16": ("fake_cuda", torch.bfloat16, 96, 64, "subclass"),
    "fake_cuda_float32": ("fake_cuda", torch.float32, 64, 64, "dtypes"),
    "fake_cuda_other_widths": ("fake_cuda", torch.bfloat16, 32, 32,
                               "widths"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_flash_dispatch_takes_the_chunk_loop(case, monkeypatch):
    """CPU tensors, float32 and float64, widths outside the compiled set
    and fake CUDA tensors (the dry-run's) take the chunk loop: the result
    is the chunk loop's (on fake CUDA tensors, which only the card's torch
    computes on, the loop is called), and neither launch counter moves."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    where, dtype, d, dv, word = DISPATCH_CASES[case]
    b, s, g = 1, 64, 2
    kw = dict(causal=True, scale=d ** -0.5, q_chunk=32, kv_chunk=32)
    before = (FK._FWD.value, FK._BWD.value)
    if where == "cpu":
        q, k, v = (torch.tensor(_rand(20 + i, *shape)).to(dtype)
                   .requires_grad_() for i, shape in enumerate(
                       ((b, s, g, 1, d), (b, g, s, d), (b, g, s, dv))))
        assert word in FK.refusal(q, k, v)
        assert FK.route(q, k, v) == "chunks"
        got = TL.flash_attention(q, k, v, **kw)
        assert torch.equal(got, TL.flash_attention_chunked(q, k, v, **kw))
        torch.autograd.grad(got.sum(), (q, k, v))
    else:
        loop = []
        monkeypatch.setattr(TL, "flash_attention_chunked",
                            lambda *a, **k_: loop.append(a) or "loop")
        with FakeTensorMode():
            q = torch.empty((b, s, g, 1, d), dtype=dtype, device="cuda")
            k = torch.empty((b, g, s, d), dtype=dtype, device="cuda")
            v = torch.empty((b, g, s, dv), dtype=dtype, device="cuda")
            assert word in FK.refusal(q, k, v)
            assert FK.route(q, k, v) == "chunks"
            assert TL.flash_attention(q, k, v, **kw) == "loop"
        assert len(loop) == 1 and loop[0][0] is q
    assert (FK._FWD.value, FK._BWD.value) == before


# q's dtype, k's and v's, key width, value width, and what ``route`` gives
# (or the word of the ValueError) for plain CUDA tensors
CARD_ROUTE_CASES = {
    "bf16_compiled": (torch.bfloat16, torch.bfloat16, 96, 64, "kernel"),
    "bf16_gqa_64": (torch.bfloat16, torch.bfloat16, 64, 64, "kernel"),
    "float32": (torch.float32, torch.float32, 80, 80, "chunks"),
    "float64": (torch.float64, torch.float64, 96, 64, "chunks"),
    "bf16_uncompiled_widths": (torch.bfloat16, torch.bfloat16, 192, 128,
                               "widths"),
    "float16": (torch.float16, torch.float16, 96, 64, "dtypes"),
    "mixed_float32_bf16": (torch.float32, torch.bfloat16, 96, 64, "dtypes"),
}


@pytest.mark.parametrize("case", sorted(CARD_ROUTE_CASES))
def test_flash_dispatch_on_the_card(case, monkeypatch):
    """Plain CUDA tensors (here fake ones counted as plain, since the CPU
    has no card): bfloat16 at a compiled width takes the kernel, float32
    and float64 the chunk loop, and anything else raises ``ValueError``
    naming what the kernel is built for, before any launch and without
    calling the chunk loop."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    qd, kd, d, dv, want = CARD_ROUTE_CASES[case]
    monkeypatch.setattr(FK, "PLAIN", FK.PLAIN + (FakeTensor,))
    loop = []
    monkeypatch.setattr(TL, "flash_attention_chunked",
                        lambda *a, **k_: loop.append(a) or "loop")
    before = (FK._FWD.value, FK._BWD.value)
    kw = dict(causal=True, scale=d ** -0.5)
    with FakeTensorMode():
        q = torch.empty((2, 1024, 4, 1, d), dtype=qd, device="cuda")
        k = torch.empty((2, 4, 1024, d), dtype=kd, device="cuda")
        v = torch.empty((2, 4, 1024, dv), dtype=kd, device="cuda")
        if want in ("kernel", "chunks"):
            assert FK.route(q, k, v) == want
            assert (FK.refusal(q, k, v) is None) == (want == "kernel")
            if want == "chunks":
                assert TL.flash_attention(q, k, v, **kw) == "loop"
        else:
            for fn in (FK.route, functools.partial(TL.flash_attention,
                                                   **kw)):
                with pytest.raises(ValueError, match=want) as err:
                    fn(q, k, v)
                assert str(FK.WIDTHS) in str(err.value)
    assert len(loop) == (want == "chunks")
    assert (FK._FWD.value, FK._BWD.value) == before


# Probabilities as the kernel meets them: a row's largest is 1; the others
# spread over many binades, some far below bf16's 8 bits of 1.
SPLIT_CASES = {
    "uniform": lambda r: r.uniform(0, 1, (64, 256)),
    "softmax_rows": lambda r: np.exp(r.normal(0, 3, (64, 256))
                                     - 12).clip(max=1.0),
    "tiny_tail": lambda r: np.exp(-r.uniform(0, 120, (64, 256))),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_flash_split_is_exact(case):
    """A float32 P split into hi + mid + lo of bfloat16 (the kernel's
    split) sums back to P exactly from 2^-100 up (below, the last part
    reaches float32's subnormals: off by under 2^-126); the three bf16
    products, each exact and summed in float32 as the tensor cores sum
    them, give P V within float32's rounding of the exact product, as the
    float32 product does. One bf16 product (P rounded to bf16) does
    not."""
    rng = np.random.default_rng(7)
    p = torch.tensor(SPLIT_CASES[case](rng), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(256, 32))).bfloat16()
    parts = FK.split3(p)
    assert all(x.dtype == torch.bfloat16 for x in parts)
    whole = sum(x.double() for x in parts)
    normal = p >= 2.0 ** -100
    assert torch.equal(whole[normal], p.double()[normal])
    assert float((whole - p.double()).abs().max()) < 2.0 ** -126
    exact = p.double() @ v.double()
    mag = p.double().abs() @ v.double().abs()
    n, eps = p.shape[1] + 2, 2.0 ** -24
    bound = n * eps / (1 - n * eps) * mag          # gamma_n |P| |V|
    split = sum(x.float() @ v.float() for x in parts)
    assert bool(((split.double() - exact).abs() <= bound).all())
    assert bool(((p @ v.float()).double() - exact).abs().le(bound).all())
    one = (p.bfloat16().float() @ v.float()).double()
    assert float(((one - exact).abs() / bound).max()) > 1.0


# (b, s, t, g, hq, d, dv, causal, q_offset)
FORMULA_CASES = {
    "mla_causal": (1, 64, 64, 3, 1, 24, 16, True, 0),
    "gqa_full_rect": (2, 32, 48, 1, 2, 16, 16, False, 0),
    "offset_rows": (1, 32, 96, 2, 1, 16, 8, True, 64),
}


def _natural_lse(q, k, *, causal, scale, q_offset):
    scores, mask = FK._scores(q, k, causal=causal, scale=scale,
                              q_offset=q_offset)
    if mask is not None:
        scores = scores.masked_fill(~mask, -torch.inf)
    return torch.logsumexp(scores, -1)


def _chunk_grads(q, k, v, dout, kw):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = TL.flash_attention_chunked(q, k, v, q_chunk=16, kv_chunk=32, **kw)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("case", sorted(FORMULA_CASES))
def test_flash_backward_formulas(case):
    """The kernel's backward formulas in plain torch (D from the float32
    O, P from the log-sum-exp, dS = P (dP - D)) equal autograd through the
    chunk loop in float64; with dS rounded to bf16 before dq and dk (and
    float32 elsewhere, as the kernel computes) they come at least as close
    to the float64 gradients as the chunk loop's autograd in bf16, and
    within 4e-3 by norm (the outputs' bf16 rounding, ~1.6e-3, and dS's)."""
    b, s, t, g, hq, d, dv, causal, off = FORMULA_CASES[case]
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=off)
    q, k, v, dout = (torch.tensor(_rand(30 + i, *shape)).double()
                     for i, shape in enumerate(
                         ((b, s, g, hq, d), (b, g, t, d), (b, g, t, dv),
                          (b, s, g, hq, dv))))
    want = _chunk_grads(q, k, v, dout, kw)
    lse = _natural_lse(q, k, **kw)
    got = FK.backward_formulas(q, k, v, want[0], lse, dout, **kw)
    for g_, w in zip(got, want[1:]):
        torch.testing.assert_close(g_, w, rtol=1e-10, atol=1e-12)

    qb, kb, vb, db = (x.bfloat16() for x in (q, k, v, dout))
    truth = _chunk_grads(*(x.double() for x in (qb, kb, vb, db)), kw)
    loop = _chunk_grads(qb, kb, vb, db, kw)
    q32, k32, v32, d32 = (x.float() for x in (qb, kb, vb, db))
    o32 = _chunk_grads(q32, k32, v32, d32, kw)[0]
    kernel = FK.backward_formulas(q32, k32, v32, o32,
                                  _natural_lse(q32, k32, **kw), d32,
                                  round_ds=torch.bfloat16, **kw)
    for name, kg, lg, tg in zip(("dq", "dk", "dv"), kernel, loop[1:],
                                truth[1:]):
        err, loop_err = _rel(kg.bfloat16(), tg), _rel(lg, tg)
        assert err <= loop_err and err < 4e-3, (name, err, loop_err)


# (s, t, q_offset, q_chunk, kv_chunk)
SKIP_CASES = {
    "square_equal_chunks": (256, 256, 0, 64, 64),
    "q_finer": (256, 256, 0, 32, 64),
    "q_coarser": (256, 256, 0, 64, 32),
    "offset_rows": (128, 384, 256, 32, 64),
    "offset_not_chunk_aligned": (96, 192, 70, 32, 64),
    "non_dividing": (96, 96, 0, 64, 64),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_flash_causal_skip_bit_for_bit(case, dtype):
    """Skipping the kv chunks that lie wholly above the diagonal (the
    kernel's rule: a chunk is visited where it holds a key at or before
    the q chunk's last position, ``q_offset`` included) changes no bit
    against the full masked loop."""
    s, t, off, qc, kc = SKIP_CASES[case]
    q = torch.tensor(_rand(40, 1, s, 2, 2, 16)).to(dtype)
    k = torch.tensor(_rand(41, 1, 2, t, 16)).to(dtype)
    v = torch.tensor(_rand(42, 1, 2, t, 8)).to(dtype)
    kw = dict(causal=True, scale=0.25, q_chunk=qc, kv_chunk=kc, q_offset=off)
    full = TL.flash_attention_chunked(q, k, v, causal_skip=False, **kw)
    skip = TL.flash_attention_chunked(q, k, v, causal_skip=True, **kw)
    assert torch.equal(skip, full)


def _count_flash(monkeypatch):
    calls = []
    real = TL.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(TL, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("arch", ["yi-9b", "minicpm3-4b"])
def test_auto_switch_at_flash_threshold(arch, monkeypatch):
    """``attn_impl="auto"`` takes the flash path from 1,024 positions:
    GQA needs s and t >= 1024 (self-attention: t == s), MLA s >= 1024."""
    _, tcfg = _cfgs(arch)
    mla = tcfg.attention == "mla"
    gen = torch.Generator().manual_seed(0)
    params = (TL.init_mla if mla else TL.init_gqa)(gen, tcfg, torch.float32)
    attend = TL.mla_attention if mla else TL.gqa_attention
    calls = _count_flash(monkeypatch)
    for s in (TL.FLASH_THRESHOLD - 1, TL.FLASH_THRESHOLD):
        x = torch.tensor(_rand(12, 1, s, tcfg.d_model))
        _, tp = _positions(1, s)
        auto, _ = attend(params, x, tp, tcfg)
        thooks.set_hooks({"attn_impl": "sdpa"})
        dense, _ = attend(params, x, tp, tcfg)
        thooks.set_hooks({})
        _close(auto, dense.numpy(), atol=2e-5, rtol=1e-4)
    assert calls == [TL.FLASH_THRESHOLD]


# --- GQA / MLA layers --------------------------------------------------------

def _pad_seq(a, axis, n):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(np.asarray(a), widths)


@pytest.mark.parametrize("impl", ["sdpa", "flash", "flash_skip"])
def test_gqa_attention_parity(impl):
    _set_flags(attn_impl=impl[:5], causal_skip=impl == "flash_skip")
    jcfg, tcfg = _cfgs("yi-9b")
    params = JL.init_gqa(jax.random.PRNGKey(1), jcfg, jnp.float32)
    b, s = 2, 12
    x = _rand(13, b, s, tcfg.d_model)
    jp, tp = _positions(b, s)
    got, tc = TL.gqa_attention(_t(params), torch.tensor(x), tp, tcfg,
                               return_cache=True)
    want, jc = _jit(JL.gqa_attention, cfg=jcfg, return_cache=True)(
        params, jnp.asarray(x), jp)
    _close(got, want)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


@pytest.mark.parametrize("arch", ["yi-9b", "minicpm3-4b"])
def test_cached_decode_parity(arch):
    """Decode against a cache built at 12 positions and padded to 20: the
    port writes the new K/V in place at the index; attention covers
    positions <= index (the absorbed latent-space path for MLA)."""
    jcfg, tcfg = _cfgs(arch)
    mla = tcfg.attention == "mla"
    params = (JL.init_mla if mla else JL.init_gqa)(jax.random.PRNGKey(2),
                                                   jcfg, jnp.float32)
    jattend = JL.mla_attention if mla else JL.gqa_attention
    tattend = TL.mla_attention if mla else TL.gqa_attention
    b, s, t = 2, 12, 20
    x = _rand(14, b, s, tcfg.d_model)
    jp, _ = _positions(b, s)
    _, jc = _jit(jattend, cfg=jcfg, return_cache=True)(
        params, jnp.asarray(x), jp)
    axis = 1 if mla else 2
    jc = type(jc)(*(jnp.asarray(_pad_seq(a, axis, t)) for a in jc))
    tc = getattr(TL, type(jc).__name__)(*(torch.tensor(np.asarray(a))
                                          for a in jc))
    jdecode = _jit(lambda p, x, pos, c, i: jattend(p, x, pos, jcfg, cache=c,
                                                   cache_index=i))
    for idx in (s, s + 1):
        x1 = _rand(15 + idx, b, 1, tcfg.d_model)
        jp1, tp1 = _positions(b, 1, start=idx)
        want, jc = jdecode(params, jnp.asarray(x1), jp1, jc, jnp.int32(idx))
        got, tc2 = tattend(_t(params), torch.tensor(x1), tp1, tcfg,
                           cache=tc, cache_index=idx)
        assert all(a is b for a, b in zip(tc2, tc))     # written in place
        _close(got, want)
        for a, b_ in zip(tc, jc):
            _close(a, b_)


@pytest.mark.parametrize("impl", ["sdpa", "flash", "flash_skip"])
def test_mla_attention_parity(impl):
    _set_flags(attn_impl=impl[:5], causal_skip=impl == "flash_skip")
    jcfg, tcfg = _cfgs("minicpm3-4b")
    params = JL.init_mla(jax.random.PRNGKey(3), jcfg, jnp.float32)
    b, s = 2, 10
    x = _rand(16, b, s, tcfg.d_model)
    jp, tp = _positions(b, s)
    got, tc = TL.mla_attention(_t(params), torch.tensor(x), tp, tcfg,
                               return_cache=True)
    want, jc = _jit(JL.mla_attention, cfg=jcfg, return_cache=True)(
        params, jnp.asarray(x), jp)
    _close(got, want)
    _close(tc.c_kv, jc.c_kv)
    _close(tc.k_rope, jc.k_rope)


def test_cache_write_past_the_end_raises():
    """A cache write that does not fit raises nowhere and follows the
    reference: one position at the end (index 8 of 8) is dropped, three
    positions at index 6 are written from 5 (``dynamic_update_slice``
    clamps the start), and attention covers positions <= the index. GQA
    and MLA, outputs and caches."""
    for arch in ("yi-9b", "minicpm3-4b"):
        jcfg, tcfg = _cfgs(arch)
        mla = tcfg.attention == "mla"
        params = (JL.init_mla if mla else JL.init_gqa)(
            jax.random.PRNGKey(4), jcfg, jnp.float32)
        jattend = JL.mla_attention if mla else JL.gqa_attention
        tattend = TL.mla_attention if mla else TL.gqa_attention
        b, t = 2, 8
        _, jc = _jit(jattend, cfg=jcfg, return_cache=True)(
            params, jnp.asarray(_rand(20, b, t, tcfg.d_model)),
            _positions(b, t)[0])
        for s, idx in ((1, 8), (3, 6)):
            tc = getattr(TL, type(jc).__name__)(
                *(torch.tensor(np.asarray(a)) for a in jc))
            x = _rand(21 + s, b, s, tcfg.d_model)
            jp, tp = _positions(b, s, start=idx)
            want, jc2 = _jit(lambda p, x, pos, c, i: jattend(
                p, x, pos, jcfg, cache=c, cache_index=i))(
                params, jnp.asarray(x), jp, jc, jnp.int32(idx))
            got, tc2 = tattend(_t(params), torch.tensor(x), tp, tcfg,
                               cache=tc, cache_index=idx)
            assert all(a is b_ for a, b_ in zip(tc2, tc))
            _close(got, want)
            for a, b_ in zip(tc, jc2):
                _close(a, b_)
            if s == 1:                          # dropped: the cache as it was
                for a, b_ in zip(tc, jc):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


# --- MLP / MoE ---------------------------------------------------------------

@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_parity(mlp_type):
    params = JL.init_mlp(jax.random.PRNGKey(4), 128, 256, mlp_type,
                         jnp.float32)
    x = _rand(17, 2, 5, 128)
    _close(TL.mlp(_t(params), torch.tensor(x), mlp_type),
           JL.mlp(params, jnp.asarray(x), mlp_type))


def test_gelu_is_the_tanh_approximation():
    """starcoder2's MLP: jax.nn.gelu defaults to the tanh form."""
    eye = {"w_in": torch.eye(4), "w_out": torch.eye(4)}
    x = torch.linspace(-3, 3, 8).reshape(1, 2, 4)
    got = TL.mlp(eye, x, "gelu")
    tanh = 0.5 * x * (1 + torch.tanh((2 / np.pi) ** 0.5
                                     * (x + 0.044715 * x ** 3)))
    _close(got, tanh.numpy(), atol=1e-6)
    assert (got - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def _moe_case(seed, b, s, **overrides):
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", **overrides)
    params = JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = _rand(seed + 100, b, s, tcfg.d_model)
    return jcfg, tcfg, params, x


def _expert_loads(params, x, cfg, axis):
    """Tokens routed to each expert, per row (axis=1) or over the batch
    (axis=None), from the router in numpy."""
    logits = np.einsum("bsd,de->bse", x, np.asarray(params["router"]))
    top = np.argsort(-logits, axis=-1)[..., :cfg.experts_per_token]
    onehot = np.eye(cfg.num_experts)[top].sum(2)             # (B,S,E)
    return onehot.sum(1) if axis == 1 else onehot.sum((0, 1))


# (b, s, config overrides, capacity the case must drop at or None)
MOE_CASES = {
    "per_row_dropless": (2, 16, {}, None),
    # tk = 600 > 512: capacity round(600 / 8 * 1.0) = 75
    "per_row_capped": (1, 300, dict(moe_capacity_factor=1.0), 75),
    "per_row_factor_below_one": (2, 40, dict(moe_capacity_factor=0.5), 5),
    "decode_dropless": (8, 1, {}, None),
    "decode_factor_4": (64, 1, dict(moe_decode_capacity_factor=4.0), None),
    # capacity round(64 * 2 / 8 * 0.5) = 8
    "decode_capped": (64, 1, dict(moe_decode_capacity_factor=0.5), 8),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_parity(case):
    b, s, overrides, cap = MOE_CASES[case]
    jcfg, tcfg, params, x = _moe_case(5, b, s, **overrides)
    got, aux = TL.moe_block(_t(params), torch.tensor(x), tcfg)
    want, jaux = _jit(JL.moe_block, cfg=jcfg)(params, jnp.asarray(x))
    _close(got, want, atol=2e-6 * float(np.abs(want).max()))
    _close(aux, jaux, atol=1e-6)
    if cap is not None:                 # the case really drops tokens
        loads = _expert_loads(params, x, tcfg, axis=1 if s > 1 else None)
        assert loads.max() > cap
        assert cap == (TL.decode_capacity(tcfg, b) if s == 1
                       else TL.row_capacity(tcfg, s))


def test_moe_capacity_rules():
    """``layers.py:446-451`` (decode) and ``:490-493`` (per row)."""
    for factor in (0.0, 0.5, 4.0):
        for e, k in ((8, 2), (64, 6)):
            _, cfg = _cfgs("moonshot-v1-16b-a3b", num_experts=e,
                           experts_per_token=k,
                           moe_decode_capacity_factor=factor,
                           moe_capacity_factor=max(factor, 0.25))
            for t in (1, 4, 64, 256, 257, 1000):
                f = factor or 4.0
                want = t if factor == 0.0 and t <= 256 else \
                    min(t, max(k, int(round(t * k / e * f))))
                assert TL.decode_capacity(cfg, t) == want
                tk = t * k
                want = tk if tk <= 512 and cfg.moe_capacity_factor >= 1.0 \
                    else int(max(1, round(tk / e * cfg.moe_capacity_factor)))
                assert TL.row_capacity(cfg, t) == want


def test_moe_run_positions_from_stable_sort_and_cummax():
    flat_e = torch.tensor([[3, 1, 3, 0, 1, 3, 1, 2]])
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    assert order.tolist() == [[3, 1, 4, 6, 7, 0, 2, 5]]     # ties keep order
    se = torch.gather(flat_e, 1, order)
    assert TL._run_starts(se).tolist() == [[0, 0, 1, 2, 0, 0, 1, 2]]
    assert TL._run_starts(se[0]).tolist() == [0, 0, 1, 2, 0, 0, 1, 2]
