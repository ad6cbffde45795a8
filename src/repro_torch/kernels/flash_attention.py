"""Flash attention on the card: a CUDA forward and backward and their plain
models.

Replaces no TPU kernel: the reference's ``models/layers.flash_attention``
is jnp (an online softmax over chunk pairs), and the port's plain version
is the same chunk loop in PyTorch (``models/layers.flash_attention_chunked``).
``csrc/flash_attention.cu`` computes a layer's forward in one launch and
its backward in two, on bf16 tensor cores (``mma.sync``), with the
kv tiles above the causal diagonal skipped; what bounds it and how its
design answers is in the source.

``models/layers.flash_attention`` asks ``route``: the kernel takes plain
CUDA tensors of bfloat16 whose (key, value) widths are in ``WIDTHS``; the
chunk loop takes CPU, fake or meta tensors and float32 / float64; any
other CUDA tensor raises ``ValueError``, so that no attention on the card
falls to the chunk loop unseen. There is no fallback after a launch.

Precision, never below the chunk loop's:

- S = Q K^T: one bf16 product, summed in float32 (the chunk loop rounds S
  to bf16 first);
- P V (forward) and P^T dO (backward): P stays float32, split exactly
  into three bf16 terms (``split3``), three products summed
  into one float32 accumulator: the float32 product up to the order of
  its sums;
- dP = dO V^T: one bf16 product;
- D = rowsum(dO * O) from the forward's float32 O;
- dS = P (dP - D), rounded to bf16 (as the chunk loop's autograd does),
  then dQ = dS K and dK = dS^T Q, each summed over all tiles in float32
  and rounded once (the chunk loop adds dQ's chunks in bf16).

``backward_formulas`` writes those formulas in plain torch (materialised
scores, for tests). Counters: ``kernel_launches_total{kernel=
"flash_attention_fwd"}`` (one a forward call) and ``{kernel=
"flash_attention_bwd"}`` (two a backward call).
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.obs.metrics import kernel_launches

_FWD = kernel_launches("flash_attention_fwd")
_BWD = kernel_launches("flash_attention_bwd")

# (key width, value width) the library is compiled for, in bfloat16 (one
# line each in the source's ``dispatch``): MiniCPM3's MLA (64 + 32, 64),
# the GQA heads of 128 (yi-9b, starcoder2-7b, moonshot) and of 64
# (whisper's encoder).
WIDTHS = ((96, 64), (128, 128), (64, 64))
PLAIN = (torch.Tensor, torch.nn.Parameter)   # tensors with memory to launch on
LOG2E = 1.4426950408889634
MAX_GRID_Y = 65535      # batch x heads of one launch


def refusal(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take (q, k, v), or None where it does."""
    ts = (q, k, v)
    if any(t.dtype != torch.bfloat16 for t in ts):
        return f"dtypes {[t.dtype for t in ts]}: not all bfloat16"
    if (q.shape[-1], v.shape[-1]) not in WIDTHS:
        return f"widths ({q.shape[-1]}, {v.shape[-1]}) not in {WIDTHS}"
    if any(type(t) not in PLAIN for t in ts):
        return "a tensor subclass (fake, DTensor): no memory to launch on"
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        return f"devices {[str(t.device) for t in ts]}: not one CUDA device"
    b, s, g, hq, _ = q.shape
    if b * s * k.shape[2] == 0 or b * g * hq > MAX_GRID_Y:
        return f"empty or more than {MAX_GRID_Y} (batch, head) pairs"
    return None


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which code computes the attention of (q, k, v): ``"kernel"`` where
    ``refusal`` finds nothing; ``"chunks"`` (the chunk loop) for CPU, fake
    or meta tensors (any subclass or device but CUDA) and for float32 and
    float64. Raises ``ValueError`` for the rest, plain CUDA tensors the
    kernel is not built for (another width or type): the chunk loop is ~25x
    slower there, and a new width is one line of the source."""
    ts = (q, k, v)
    if (any(type(t) not in PLAIN or t.device.type != "cuda" for t in ts)
            or all(t.dtype in (torch.float32, torch.float64) for t in ts)):
        return "chunks"
    why = refusal(q, k, v)
    if why is None:
        return "kernel"
    raise ValueError(f"flash attention on the card: {why}; the kernel is "
                     f"built for bfloat16 at (key, value) widths {WIDTHS} "
                     f"(add one to the source's dispatch), the chunk loop "
                     f"takes float32 and float64")


def split3(p: torch.Tensor):
    """The bf16 kernel's split of a float32 ``p`` into three bfloat16
    values whose sum is ``p``: each of ``hi`` and ``mid``
    truncates 8 significant bits off what is left, and the rest has at
    most 8 bits left. Exact from 2^-100 up; below, the last part reaches
    float32's subnormals and may lose bits (an error under 2^-126).
    Returns (hi, mid, lo)."""
    u = p.float().contiguous().view(torch.int32)
    hi = (u & -65536).view(torch.float32)
    r1 = p.float() - hi
    mid = (r1.view(torch.int32) & -65536).view(torch.float32)
    lo = r1 - mid
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def _scores(q, k, *, causal, scale, q_offset):
    """Materialised scale * q k^T, (B, G, Hq, S, T), in q's dtype, and the
    causal mask (S, T) or None."""
    s, t = q.shape[1], k.shape[2]
    scores = torch.einsum("bsghk,bgtk->bghst", q, k) * scale
    mask = None
    if causal:
        pos = q_offset + torch.arange(s, device=q.device)
        mask = torch.arange(t, device=q.device)[None, :] <= pos[:, None]
    return scores, mask


def backward_formulas(q, k, v, o32, lse, dout, *, causal: bool,
                      scale: float, q_offset: int = 0,
                      round_ds: Optional[torch.dtype] = None):
    """dq, dk, dv by the kernel's formulas, on materialised scores.

    q (B,S,G,Hq,K), k (B,G,T,K), v (B,G,T,Kv); ``o32`` the forward's output
    (B,S,G,Hq,Kv) and ``lse`` its natural row log-sum-exp (B,G,Hq,S), both
    in the computing dtype (q's, float32 or float64); ``dout`` like o32.
    D = rowsum(dout * o32), P = exp(scale q k^T - lse), dP = dout v^T,
    dS = P (dP - D); with ``round_ds`` dS is rounded to that dtype before
    dq = scale dS k and dk = scale dS^T q (products in q's dtype)."""
    wide = q.dtype
    scores, mask = _scores(q, k, causal=causal, scale=scale,
                           q_offset=q_offset)
    p = torch.exp(scores - lse[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    d = (dout * o32).sum(-1).permute(0, 2, 3, 1)            # (B,G,Hq,S)
    dp = torch.einsum("bsghv,bgtv->bghst", dout, v)
    ds = p * (dp - d[..., None])
    if round_ds is not None:
        ds = ds.to(round_ds).to(wide)
    dq = torch.einsum("bghst,bgtk->bsghk", ds, k) * scale
    dk = torch.einsum("bghst,bsghk->bgtk", ds, q) * scale
    dv = torch.einsum("bghst,bsghv->bgtv", p, dout)
    return dq, dk, dv


def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention")
    ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    f32 = ctypes.c_float
    lib.flash_attention_fwd.argtypes = ([i32] * 2 + [ptr] * 6 + [i64p]
                                        + [i32] * 7 + [f32] * 2 + [ptr])
    lib.flash_attention_bwd.argtypes = ([i32] * 2 + [ptr] * 10 + [i64p]
                                        + [i32] * 7 + [f32] * 2 + [ptr])
    for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd):
        fn.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [i32] * 3
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def smem_bytes(which: int, d: int, dv: int) -> int:
    """Shared memory a CTA takes, as the built library computes it: kernel
    ``which`` 0 forward, 1 dq, 2 dk / dv."""
    return _library().flash_attention_smem_bytes(which, d, dv)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the kernel can read it in 16-byte rows (last stride 1,
    the others multiples of 8 elements, 16-byte aligned), else a copy."""
    if (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _args(q, k, v, causal, scale, q_offset):
    b, s, g, hq, d = q.shape
    strides = (ctypes.c_longlong * 10)(*q.stride()[:4], *k.stride()[:3],
                                       *v.stride()[:3])
    sizes = (b, s, k.shape[2], g, hq, int(bool(causal)), int(q_offset))
    return strides, sizes, (float(scale) * LOG2E, float(scale))


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash attention {what} launch failed: "
                           f"{'width not compiled' if err < 0 else 'CUDA error'}"
                           f" {err}")


def _forward(q, k, v, causal, scale, q_offset, keep: bool):
    """(out, float32 out or None, base-2 log-sum-exp (B,G,Hq,S))."""
    q, k, v = (_aligned(t) for t in (q, k, v))
    b, s, g, hq, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((b, s, g, hq, dv), dtype=q.dtype, device=q.device)
    out32 = torch.empty(out.shape, dtype=torch.float32,
                        device=q.device) if keep else None
    lse = torch.empty((b, g, hq, s), dtype=torch.float32, device=q.device)
    strides, sizes, scales = _args(q, k, v, causal, scale, q_offset)
    err = _library().flash_attention_fwd(
        d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        out32.data_ptr() if keep else None, lse.data_ptr(), strides, *sizes,
        *scales, _stream(q))
    _check(err, "forward")
    _FWD.inc()
    return out, out32, lse


def _backward(q, k, v, out32, lse, dout, causal, scale, q_offset):
    q, k, v = (_aligned(t) for t in (q, k, v))
    dout = dout.to(q.dtype).contiguous()
    b, s, g, hq, d = q.shape
    dv = v.shape[-1]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dvv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dsum = torch.empty_like(lse)
    strides, sizes, scales = _args(q, k, v, causal, scale, q_offset)
    err = _library().flash_attention_bwd(
        d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        out32.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), strides, *sizes, *scales, _stream(q))
    _check(err, "backward")
    _BWD.inc(2)
    return dq, dk, dvv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        out, out32, lse = _forward(q, k, v, causal, scale, q_offset,
                                   keep=True)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        return (*_backward(q, k, v, out32, lse, dout, *ctx.args),
                None, None, None)


def flash_attention(q, k, v, *, causal: bool, scale: float,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B,S,G,Hq,K) over k (B,G,T,K), v (B,G,T,Kv) ->
    (B,S,G,Hq,Kv) in q's dtype, on the card (``refusal`` must find
    nothing); the query at row i sits at position ``q_offset + i``.
    Differentiable in q, k and v; without a gradient to record it keeps
    no float32 output."""
    why = refusal(q, k, v)
    if why is not None:
        raise ValueError(f"the flash attention kernel does not take these "
                         f"tensors: {why}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, q_offset)
    return _forward(q, k, v, causal, scale, q_offset, keep=False)[0]


def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("flash_attention")
    _build.load_library.cache_clear()
    _build.load_library("flash_attention")
    return time.perf_counter() - t0, report

