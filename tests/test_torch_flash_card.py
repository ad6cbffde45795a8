"""On the card: the flash attention kernel (``csrc/flash_attention.cu``)
against the chunk loop (``layers.flash_attention_chunked``), forward and
all three gradients. Run on a GPU with
``python3 -m pytest -q --noconftest -m card tests/test_torch_flash_card.py``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the GPU
machine need not have; this file imports none). Without CUDA they skip.

The yardstick is the float32 computation: the chunk loop on the inputs cast
to float32 (scores, softmax and both products in float32) and its autograd
for the gradients. The kernel must come at least as close to it as the
chunk loop in bf16 does (that loop rounds the scores to bf16, the kernel
keeps them in float32), and within ``REL_TOL`` of it by norm: the outputs
are rounded to bf16 once (relative rounding up to 2^-9, ~1.6e-3 over a
tensor's norm), and dS is rounded to bf16 before dq and dk, as the chunk
loop's autograd rounds it.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as FK
from repro_torch.models import layers as L

REL_TOL = 4e-3

# (b, s, t, g, hq, k, kv, causal, q_offset, views): with ``views`` k and v
# are (B,G,T,.) views of (B,T,G,.) tensors, as MLA passes them in the train
# step; otherwise contiguous. All bfloat16, the one type compiled.
CASES = {
    "minicpm3_mla": (2, 4096, 4096, 40, 1, 96, 64, True, 0, False),
    "minicpm3_mla_views": (2, 4096, 4096, 40, 1, 96, 64, True, 0, True),
    "gqa_hq4_128": (1, 2048, 2048, 4, 4, 128, 128, True, 0, False),
    "full_rect_64": (2, 1000, 1500, 4, 2, 64, 64, False, 0, False),
    "offset_rows": (1, 1024, 3072, 8, 1, 96, 64, True, 2048, False),
}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # The float32 yardstick in full float32, not TF32.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _inputs(case, dev, seed=0):
    b, s, t, g, hq, k, kv, causal, off, views = CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q = draw(b, s, g, hq, k)
    if views:
        kk = draw(b, t, g, k).transpose(1, 2)
        v = draw(b, t, g, kv).transpose(1, 2)
    else:
        kk, v = draw(b, g, t, k), draw(b, g, t, kv)
    dout = draw(b, s, g, hq, kv)
    kw = dict(causal=causal, scale=k ** -0.5, q_offset=off)
    return q, kk, v, dout, kw


def _grads(fn, q, k, v, dout, kw):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v, **kw)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_against_the_chunk_loop(case, cuda):
    q, k, v, dout, kw = _inputs(case, cuda)
    assert FK.refusal(q, k, v) is None
    assert not CASES[case][-1] or not k.is_contiguous()
    fwd0 = FK._FWD.value
    got = _grads(FK.flash_attention, q, k, v, dout, kw)
    assert FK._FWD.value == fwd0 + 1
    low = _grads(L.flash_attention_chunked, q, k, v, dout, kw)
    f32 = _grads(L.flash_attention_chunked, q.float(), k.float(), v.float(),
                 dout.float(), kw)
    for name, g, c, w in zip(("out", "dq", "dk", "dv"), got, low, f32):
        assert g.dtype == q.dtype and g.shape == w.shape, name
        err, loop_err = _rel(g, w), _rel(c, w)
        print(f"{case} {name}: kernel {err:.3e}, chunk loop {loop_err:.3e}")
        assert err <= loop_err, (name, err, loop_err)
        assert err < REL_TOL, (name, err)


@pytest.mark.card
@pytest.mark.parametrize("case", ["minicpm3_mla", "gqa_hq4_128"])
def test_two_calls_equal_bit_for_bit(case, cuda):
    q, k, v, dout, kw = _inputs(case, cuda, seed=1)
    first = _grads(FK.flash_attention, q, k, v, dout, kw)
    second = _grads(FK.flash_attention, q, k, v, dout, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.card
def test_inference_keeps_no_float32_output(cuda):
    """Without a gradient to record the forward launches alone, and its
    output equals the recorded call's bit for bit."""
    q, k, v, dout, kw = _inputs("gqa_hq4_128", cuda, seed=2)
    with torch.no_grad():
        plain = L.flash_attention(q, k, v, **kw)
    recorded = _grads(L.flash_attention, q, k, v, dout, kw)[0]
    assert torch.equal(plain, recorded)


@pytest.mark.card
@pytest.mark.parametrize("dtype,d,dv", [(torch.bfloat16, 192, 128),
                                        (torch.float16, 96, 64)])
def test_uncompiled_tensors_raise(dtype, d, dv, cuda):
    """A CUDA tensor the kernel is not built for (another width or type)
    raises ``ValueError`` in ``layers.flash_attention``: no launch, and no
    quiet turn to the chunk loop on the card."""
    q = torch.zeros((1, 1024, 2, 1, d), dtype=dtype, device=cuda)
    k = torch.zeros((1, 2, 1024, d), dtype=dtype, device=cuda)
    v = torch.zeros((1, 2, 1024, dv), dtype=dtype, device=cuda)
    before = (FK._FWD.value, FK._BWD.value)
    with pytest.raises(ValueError, match="built for bfloat16"):
        L.flash_attention(q, k, v, causal=True, scale=d ** -0.5)
    assert (FK._FWD.value, FK._BWD.value) == before
