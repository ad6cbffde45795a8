"""Model components for the architecture zoo (the port of the reference's
``models/layers.py``).

Conventions, as in the reference:
  - parameters are groups named like the reference's dicts (``p["wq"]``);
    ``init_*`` builds them, the apply functions read them. A group is a
    ``Params`` module, so a model's ``state_dict`` keys are the
    reference's dict paths (``layers.0.attn.wq``).
  - activations (B, S, D); caches are explicit NamedTuples.
  - dims named in einsums: b batch, s/t seq, d model, h heads, g kv-heads,
    k head_dim, f ffn, e experts, c capacity/latent, n ssm-state, p
    ssm-head-dim, q chunk.

The arithmetic follows the reference op for op: products are einsums,
attention scores are float32 and masked with -1e30, probabilities are
cast to ``v``'s dtype before the PV product. Decode writes the new
token's K/V into the cache's tensors in place; a cache index is a host
integer shared by the whole batch. Where the reference computes in
float32, the port computes in float32 or wider (``wide``): a float64
model stays float64 throughout, which the gradient checks use.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.models.sharding_hooks import (batch_placements, constrain,
                                               einsum, get_flag, get_hooks,
                                               on_local, run_local)


class Params(nn.Module):
    """Named tensors and sub-groups, read like the reference's dicts.

    Tensors become parameters that need no gradient (the serving path);
    a training caller turns gradients on with ``requires_grad_()``.
    """

    def __init__(self, **items):
        super().__init__()
        for name, v in items.items():
            if isinstance(v, nn.Module):
                self.add_module(name, v)
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._parameters or name in self._modules


def _init(gen: Optional[torch.Generator], shape, scale=None,
          dtype=torch.float32, device=None) -> torch.Tensor:
    """normal(shape) * scale (default 1/sqrt(shape[0])) drawn from ``gen``
    on its device; with ``gen`` None, an uninitialised tensor on
    ``device`` (filled later, e.g. by ``interop.lm_params_from_numpy``)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    scale = scale if scale is not None else (1.0 / (shape[0] ** 0.5))
    draw = torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
    return (draw * scale).to(dtype)


def _ones(shape, dtype, gen, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype,
                      device=gen.device if gen is not None else device)


def _zeros(shape, dtype, gen, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype,
                       device=gen.device if gen is not None else device)


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype where that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: rows of the (V, D) table for (B, S) tokens. On a
    mesh each rank looks its batch rows up in the whole table
    (``run_local``): the output is split by batch over the batch axes
    (``batch_placements``), the table's gradient a ``Partial`` sum there.
    DTensor's own lookup keeps the table's layout (its feature dim over
    "data"), so every product of the first layer would split its sum,
    and torch 2.11 cannot propagate the lookup's backward (``index_put``)
    from batch-split rows."""
    if not (isinstance(table, DTensor) or isinstance(tokens, DTensor)):
        return table[tokens]
    mesh = (table if isinstance(table, DTensor) else tokens).device_mesh
    rows = batch_placements(mesh, tokens.shape[0])
    whole = (Replicate(),) * mesh.ndim
    table_grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                       for p in rows)
    return run_local(lambda t, i: t[i], mesh, (table, tokens), (whole, rows),
                     rows, tuple(tokens.shape) + (table.shape[1],),
                     (table_grad, rows))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = wide(x)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, K) with K even; positions: (B, S) int. Rotates the
    split halves (x1, x2) = x[..., :K/2], x[..., K/2:], not interleaved
    pairs; angles in float32."""
    k = x.shape[-1]
    freqs = rope_freqs(k, theta, x.device)                 # (K/2,)
    angles = positions[..., None].float() * freqs          # (B, S, K/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(wide(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, G, S, K)
    v: torch.Tensor  # (B, G, S, K)


def init_gqa(gen, cfg: ArchConfig, dtype, device=None) -> Params:
    d, h, g = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    k = cfg.resolved_head_dim
    return Params(
        wq=_init(gen, (d, h, k), dtype=dtype, device=device),
        wk=_init(gen, (d, g, k), dtype=dtype, device=device),
        wv=_init(gen, (d, g, k), dtype=dtype, device=device),
        wo=_init(gen, (h, k, d), scale=1.0 / (h * k) ** 0.5, dtype=dtype,
                 device=device))


def _sdpa(q, k, v, mask):
    """q (B,S,G,Hq,K), k/v (B,G,T,K), mask (B,1,1,S,T)-broadcastable or
    None. Materialized float32 softmax."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = wide(torch.einsum("bsghk,bgtk->bghst", q, k) * scale)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bghst,bgtk->bsghk", probs, v)


# Sequence length above which the prefill path switches from the
# materialized softmax to the chunked online-softmax (flash) formulation.
FLASH_THRESHOLD = 1024
FLASH_Q_CHUNK = 512
FLASH_KV_CHUNK = 1024


def flash_attention(q, k, v, *, causal: bool, scale: float,
                    q_chunk: int = FLASH_Q_CHUNK,
                    kv_chunk: int = FLASH_KV_CHUNK,
                    causal_skip: bool = False, q_offset: int = 0):
    """Online-softmax (flash) attention in GQA layout.

    q (B,S,G,Hq,K), k (B,G,T,K), v (B,G,T,Kv) -> out (B,S,G,Hq,Kv).
    ``q_offset`` is the position of q's first row (a rank's block of the
    query rows).

    Which code computes it follows from the tensors alone
    (``kernels/flash_attention.route``): the CUDA kernel
    (``kernels/flash_attention.flash_attention``, which always skips the
    kv tiles above the causal diagonal and ignores the chunk sizes) takes
    plain CUDA tensors of bfloat16 whose (key, value) widths are compiled
    (``kernels/flash_attention.WIDTHS``); the chunk loop
    (``flash_attention_chunked``, the plain version) takes CPU, fake or
    meta tensors, float32 and float64. Any other CUDA tensor (another
    width or type) raises ``ValueError``; nothing falls back after a
    launch.
    """
    if _flash_kernel.route(q, k, v) == "kernel":
        return _flash_kernel.flash_attention(q, k, v, causal=causal,
                                             scale=scale, q_offset=q_offset)
    return flash_attention_chunked(q, k, v, causal=causal, scale=scale,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   causal_skip=causal_skip,
                                   q_offset=q_offset)


def flash_attention_chunked(q, k, v, *, causal: bool, scale: float,
                            q_chunk: int = FLASH_Q_CHUNK,
                            kv_chunk: int = FLASH_KV_CHUNK,
                            causal_skip: bool = False, q_offset: int = 0):
    """The plain version of ``flash_attention``: the online softmax over
    chunk pairs, O(qc*kc) score memory (the reference's loop).

    A chunk count falls back to 1 when the length is not a multiple of
    the chunk (or is shorter). With ``causal_skip`` q chunk ``iq`` visits
    only the kv chunks that hold a key at or before its last row's
    position (``q_offset + (iq + 1) * qc - 1``), the rule the kernel's
    tiles follow. The chunks left out lie wholly above the diagonal:
    visited, every score there is -1e30, so ``exp`` gives exactly 0 and
    ``alpha`` exactly 1 (chunk 0 comes first and holds key 0, which every
    row sees), and the skip changes no bit. Where q and k chunks are equal
    and ``s == t``, that is chunks ``0..iq``, as the reference's while
    loop visits; the reference's visits past the last kv chunk read a
    clamped, fully masked chunk and add nothing.
    """
    b, s, g, hq, _ = q.shape
    t = k.shape[2]
    dv = v.shape[-1]
    nq = s // q_chunk if (s % q_chunk == 0 and s >= q_chunk) else 1
    qc = s // nq
    nk = t // kv_chunk if (t % kv_chunk == 0 and t >= kv_chunk) else 1
    kc = t // nk
    dev = q.device
    acc_dtype = torch.promote_types(q.dtype, torch.float32)
    skip = causal_skip and causal

    outs = []
    for iq in range(nq):
        qi = q[:, iq * qc:(iq + 1) * qc]                    # (B,qc,G,Hq,K)
        q_pos = q_offset + iq * qc + torch.arange(qc, device=dev)
        acc = torch.zeros((b, g, hq, qc, dv), dtype=acc_dtype, device=dev)
        m = torch.full((b, g, hq, qc), -torch.inf, dtype=acc_dtype,
                       device=dev)
        l = torch.zeros((b, g, hq, qc), dtype=acc_dtype, device=dev)
        last = q_offset + (iq + 1) * qc - 1
        for jk in range(min(nk, last // kc + 1) if skip else nk):
            kj = k[:, :, jk * kc:(jk + 1) * kc]              # (B,G,kc,K)
            vj = v[:, :, jk * kc:(jk + 1) * kc]
            scores = torch.einsum("bqghk,bgtk->bghqt", qi, kj) * scale
            scores = wide(scores)
            if causal:
                k_pos = jk * kc + torch.arange(kc, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                scores = scores.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, scores.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bghqt,bgtv->bghqv", p, wide(vj))
            m = m_new
        out = (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
        outs.append(out.movedim(3, 1))                     # (B,qc,G,Hq,Kv)
    return torch.cat(outs, dim=1)


def _on_ranks(core, tensors, dims, hook: str, groups: int, **kw):
    """``core(*tensors, q_offset=0, head_offset=0, **kw)``, the attention
    between the projections, which gives (B, S, H, Kv) with H the first
    tensor's heads and Kv the last tensor's last dim. ``dims`` gives each
    tensor's (head dim, query-row dim), None where it has none; dim 0 is
    the batch of every tensor; ``groups`` is the number of kv groups.

    On DTensors each rank runs ``core`` on its shards (``run_local``),
    so DTensor never sees the core's reshapes: the batch is split as the
    largest tensor splits it, else as ``batch_placements`` does; on the
    "model" axis the ranks split the query rows where the hook ``hook``
    is set (the reference's sequence-sharded scores) and the rows
    divide, else the heads: by kv group where ``groups`` divide, or where
    each rank's query heads lie in one group (the rank then takes its
    group from the whole keys), else each rank computes them all.
    ``q_offset`` and ``head_offset`` are the global index of the rank's
    first query row and head. A tensor that is replicated on an axis
    that splits the work takes its gradient there as a ``Partial``
    sum."""
    if not any(isinstance(t, DTensor) for t in tensors):
        return core(*tensors, q_offset=0, head_offset=0, **kw)
    lead = next(t for t in tensors if isinstance(t, DTensor))
    mesh = lead.device_mesh
    q = tensors[0]
    batch, rows, heads = q.shape[:3]
    placements = [[] for _ in tensors]
    grads = [[] for _ in tensors]
    out, offsets = [], {"q_offset": 0, "head_offset": 0}
    # The batch split of the largest tensor (a decode step's cache) where
    # it has one, so that only the small ones move.
    big = max(tensors, key=lambda t: t.numel())
    rows_split = batch_placements(mesh, batch)
    if isinstance(big, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in big.placements):
        rows_split = tuple(p if isinstance(p, Shard) and p.dim == 0
                           else Replicate() for p in big.placements)
    for axis, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(axis)
        split = name == "model" and size > 1
        if isinstance(rows_split[axis], Shard):
            pick, out_dim = (lambda d: 0), 0
        elif split and rows > 1 and rows % size == 0 and \
                get_hooks().get(hook) is not None:
            pick, out_dim = (lambda d: d[1]), 1
            offsets["q_offset"] = mesh.get_local_rank(axis) * (rows // size)
        elif split and groups % size == 0:
            pick, out_dim = (lambda d: d[0]), 2
            offsets["head_offset"] = mesh.get_local_rank(axis) * (
                heads // size)
        elif split and heads % size == 0 and \
                (heads // groups) % (heads // size) == 0:
            pick, out_dim = (lambda d: d[0] if d[1] is not None else None), 2
            offsets["head_offset"] = mesh.get_local_rank(axis) * (
                heads // size)
        else:
            pick, out_dim = (lambda d: None), None
        for i, d in enumerate(dims):
            dim = pick(d)
            placements[i].append(Replicate() if dim is None else Shard(dim))
            grads[i].append(Shard(dim) if dim is not None else Replicate()
                            if out_dim is None else Partial())
        out.append(Replicate() if out_dim is None else Shard(out_dim))
    shape = tuple(q.shape[:3]) + (tensors[-1].shape[-1],)
    return run_local(functools.partial(core, **offsets, **kw), mesh,
                     tensors, placements, out, shape, grads)


def _gqa_core(q, k, v, *, q_offset: int, head_offset: int, hq: int,
              causal: bool, cache_index: Optional[int], flash: bool,
              causal_skip: bool):
    """GQA attention on plain tensors: q (B,S,H,K) whose first row is at
    ``q_offset`` and first head at ``head_offset``, ``hq`` query heads a
    kv group, k/v (B,G,T,K) -> (B,S,H,K). Where q holds part of one
    group's heads, that group is taken from k and v. With
    ``cache_index`` (decode) it attends over positions <= cache_index."""
    b, s, h, hd = q.shape
    if h < hq:
        g0 = head_offset // hq
        k, v = k[:, g0:g0 + 1], v[:, g0:g0 + 1]
    g, t = k.shape[1], k.shape[2]
    q = q.reshape(b, s, g, h // g, hd)
    if cache_index is not None:
        tpos = torch.arange(t, device=q.device)[None, None, None, None, :]
        out = _sdpa(q, k, v, tpos <= cache_index)
    elif flash:
        out = flash_attention(q, k, v, causal=causal,
                              scale=1.0 / (hd ** 0.5),
                              causal_skip=causal_skip, q_offset=q_offset)
    else:
        mask = None
        if causal:
            qpos = q_offset + torch.arange(s, device=q.device)
            tpos = torch.arange(t, device=q.device)
            mask = (tpos[None, :] <= qpos[:, None])[None, None, None]
        out = _sdpa(q, k, v, mask)
    return out.reshape(b, s, h, -1)


def _write_cache(buf: torch.Tensor, new: torch.Tensor, cache_index: int,
                 dim: int) -> None:
    """Write ``new``'s positions (along ``dim``) into ``buf`` in place at
    ``cache_index``, as the reference's updates do: one position at or
    past the cache's end is dropped (``.at[].set``), and several
    positions start at ``cache_index`` clamped into ``[0, t - s]``
    (``dynamic_update_slice``)."""
    t, s = buf.shape[dim], new.shape[dim]
    if s == 1:
        if cache_index >= t:
            return
        start = cache_index
    else:
        start = min(max(cache_index, 0), t - s)
    buf.narrow(dim, start, s).copy_(new)


def gqa_attention(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ArchConfig, *, causal: bool = True,
                  cache: Optional[KVCache] = None,
                  cache_index: Optional[int] = None,
                  return_cache: bool = False,
                  kv_x: Optional[torch.Tensor] = None,
                  static_kv: Optional[KVCache] = None):
    """GQA attention; cross-attention when ``kv_x`` or ``static_kv`` is
    given.

    Modes:
      - cache is None: full self-attention over x (prefill); when
        return_cache, also emits the packed cache.
      - cache given + cache_index (a host int): decode — new tokens
        written into the cache in place at cache_index (``_write_cache``:
        dropped or clamped at the cache's end), attention over positions
        <= cache_index.
      - kv_x: K/V projected from ``kv_x`` (the encoder's output), no RoPE
        on Q or K, not causal.
      - static_kv: precomputed cross-attention K/V (B, G, T, K): no
        projection, no cache write, always the materialized softmax;
        returns (y, None).
    """
    s = x.shape[1]
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    use_flash, index = False, None
    if static_kv is not None:
        k, v, new_cache, causal = static_kv.k, static_kv.v, None, False
    else:
        src = x if kv_x is None else kv_x
        k = einsum("bsd,dgk->bsgk", src, params["wk"])
        v = einsum("bsd,dgk->bsgk", src, params["wv"])
        if kv_x is None:                    # RoPE only for self-attention
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        else:
            causal = False
        k = k.transpose(1, 2)                              # (B, G, T, K)
        v = v.transpose(1, 2)
        if cache is not None:
            _write_cache(cache.k, k, cache_index, 2)
            _write_cache(cache.v, v, cache_index, 2)
            k, v, new_cache, index = cache.k, cache.v, cache, cache_index
        else:
            impl = get_flag("attn_impl", "auto")
            use_flash = impl == "flash" or (
                impl == "auto" and s >= FLASH_THRESHOLD
                and k.shape[2] >= FLASH_THRESHOLD)
            new_cache = KVCache(k, v) if return_cache else None
    out = _on_ranks(_gqa_core, (q, k, v), ((2, 1), (1, None), (1, None)),
                    "attn_scores_gqa", cfg.num_kv_heads,
                    hq=cfg.num_heads // cfg.num_kv_heads, causal=causal,
                    cache_index=index, flash=use_flash,
                    causal_skip=bool(get_flag("causal_skip", False)))
    y = einsum("bshk,hkd->bsd", out, params["wo"])
    if static_kv is not None:
        return y, None
    return (y, new_cache) if (return_cache or cache is not None) else (y, None)


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, C) compressed latent
    k_rope: torch.Tensor  # (B, S, R) shared rotary key


def init_mla(gen, cfg: ArchConfig, dtype, device=None) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return Params(
        w_dq=_init(gen, (d, qr), dtype=dtype, device=device),
        q_norm=_ones((qr,), dtype, gen, device),
        w_uq=_init(gen, (qr, h, nd + rd), dtype=dtype, device=device),
        w_dkv=_init(gen, (d, kr), dtype=dtype, device=device),
        kv_norm=_ones((kr,), dtype, gen, device),
        w_kr=_init(gen, (d, rd), dtype=dtype, device=device),
        w_uk=_init(gen, (kr, h, nd), dtype=dtype, device=device),
        w_uv=_init(gen, (kr, h, vd), dtype=dtype, device=device),
        wo=_init(gen, (h, vd, d), scale=1.0 / (h * vd) ** 0.5, dtype=dtype,
                 device=device))


def _mla_core(q_nope, q_rope, k_nope, kr, v, *, q_offset: int,
              head_offset: int, scale: float, flash: bool,
              causal_skip: bool):
    """Causal MLA attention on plain tensors: q_nope (B,S,H,N), q_rope
    (B,S,H,R) whose first row is at ``q_offset``, k_nope (B,T,H,N), the
    shared rotary key kr (B,T,R), v (B,T,H,V) -> (B,S,H,V). Every head
    has its own key, so ``head_offset`` is not needed."""
    b, s, h, nd = q_nope.shape
    t, rd = k_nope.shape[1], kr.shape[-1]
    if flash:
        # concat nope+rope dims; per-head keys -> GQA layout g=h, hq=1
        q_cat = torch.cat([q_nope, q_rope], -1)             # (B,S,H,nd+rd)
        k_cat = torch.cat(
            [k_nope, kr[:, :, None, :].expand(b, t, h, rd)], -1)
        out = flash_attention(
            q_cat.reshape(b, s, h, 1, nd + rd),
            k_cat.transpose(1, 2), v.transpose(1, 2),
            causal=True, scale=scale, causal_skip=causal_skip,
            q_offset=q_offset)
        return out.reshape(b, s, h, -1)
    scores = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
              + torch.einsum("bshr,btr->bhst", q_rope, kr)) * scale
    scores = wide(scores)
    qpos = q_offset + torch.arange(s, device=q_nope.device)
    mask = torch.arange(t, device=q_nope.device)[None, :] <= qpos[:, None]
    scores = scores.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthv->bshv", probs, v)


def mla_attention(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ArchConfig, *, cache: Optional[MLACache] = None,
                  cache_index: Optional[int] = None,
                  return_cache: bool = False):
    s = x.shape[1]
    nd, rd = cfg.nope_head_dim, cfg.rope_head_dim
    scale = 1.0 / ((nd + rd) ** 0.5)

    cq = rmsnorm(params["q_norm"],
                 einsum("bsd,dc->bsc", x, params["w_dq"]), cfg.norm_eps)
    q = einsum("bsc,chk->bshk", cq, params["w_uq"])
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = rmsnorm(params["kv_norm"],
                  einsum("bsd,dc->bsc", x, params["w_dkv"]), cfg.norm_eps)
    kr_new = einsum("bsd,dr->bsr", x, params["w_kr"])[:, :, None, :]
    kr_new = apply_rope(kr_new, positions, cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        t = cache.c_kv.shape[1]
        _write_cache(cache.c_kv, ckv, cache_index, 1)
        _write_cache(cache.k_rope, kr_new, cache_index, 1)
        c_all, r_all = cache.c_kv, cache.k_rope
        # Absorbed decode: score directly in the latent space, with no
        # per-step K/V re-expansion.
        q_lat = einsum("bshn,chn->bshc", q_nope, params["w_uk"])
        scores = (einsum("bshc,btc->bhst", q_lat, c_all)
                  + einsum("bshr,btr->bhst", q_rope, r_all)) * scale
        tpos = torch.arange(t, device=x.device)[None, None, None, :]
        scores = wide(scores).masked_fill(~(tpos <= cache_index), -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out_lat = einsum("bhst,btc->bshc", probs, c_all)
        out = einsum("bshc,chv->bshv", out_lat, params["w_uv"])
        new_cache = cache
    else:
        k_nope = einsum("btc,chn->bthn", ckv, params["w_uk"])
        v = einsum("btc,chv->bthv", ckv, params["w_uv"])
        impl = get_flag("attn_impl", "auto")
        use_flash = impl == "flash" or (impl == "auto"
                                        and s >= FLASH_THRESHOLD)
        out = _on_ranks(
            _mla_core, (q_nope, q_rope, k_nope, kr_new, v),
            ((2, 1), (2, 1), (2, None), (None, None), (2, None)),
            "attn_scores_mla", cfg.num_heads, scale=scale, flash=use_flash,
            causal_skip=bool(get_flag("causal_skip", False)))
        new_cache = MLACache(ckv, kr_new) if return_cache else None

    y = einsum("bshv,hvd->bsd", out, params["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs + MoE
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, f: int, mlp_type: str, dtype,
             device=None) -> Params:
    p = dict(w_in=_init(gen, (d, f), dtype=dtype, device=device),
             w_out=_init(gen, (f, d), dtype=dtype, device=device))
    if mlp_type == "swiglu":
        p["w_gate"] = _init(gen, (d, f), dtype=dtype, device=device)
    return Params(**p)


def mlp(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    h = einsum("bsd,df->bsf", x, params["w_in"])
    if mlp_type == "swiglu":
        g = einsum("bsd,df->bsf", x, params["w_gate"])
        h = F.silu(g) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(h, approximate="tanh")
    return einsum("bsf,fd->bsd", h, params["w_out"])


def init_moe(gen, cfg: ArchConfig, dtype, device=None) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = dict(
        # the router stays float32 whatever the model's dtype
        router=_init(gen, (d, e), scale=0.02, dtype=torch.float32,
                     device=device),
        w_in=_init(gen, (e, d, f), dtype=dtype, device=device),
        w_gate=_init(gen, (e, d, f), dtype=dtype, device=device),
        w_out=_init(gen, (e, f, d), dtype=dtype, device=device))
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, f * cfg.num_shared_experts,
                               "swiglu", dtype, device)
    return Params(**p)


def moe_block(params, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with a capacity cap: each expert's load is capped at
    (capacity_factor x ideal); overflow tokens drop to the shared-expert /
    residual path.

    Prefill dispatches per sequence (each batch row sorts its own tokens
    into expert bins); decode (s == 1) dispatches the whole token batch
    into one capped expert buffer.

    Returns (output, aux_load_balance_loss). ``torch.topk`` may break
    exact ties in the router's probabilities differently from
    ``jax.lax.top_k`` (lower index first); random routers have none.
    """
    _, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token

    logits = einsum("bsd,de->bse", wide(x), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)   # (B, S, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # aux loss (Switch-style), normalized by k so uniform routing -> 1.0
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(expert_idx, e).sum(2).float(), dim=(0, 1))
    aux = torch.sum(me * ce) * e / max(k, 1)

    if s == 1:
        y = _moe_decode_dispatch(params, x, gate_vals, expert_idx, cfg)
    else:
        y = _moe_dispatch_per_row(params, x, gate_vals, expert_idx, cfg)

    if "shared" in params:
        y = y + mlp(params["shared"], x, "swiglu")
    return y, aux


def _run_starts(se: torch.Tensor) -> torch.Tensor:
    """Each element's position within its run of equal experts, along the
    last axis of the sorted expert ids ``se``."""
    ar = torch.arange(se.shape[-1], device=se.device).expand_as(se)
    new_run = torch.ones_like(se, dtype=torch.bool)
    new_run[..., 1:] = se[..., 1:] != se[..., :-1]
    run_start = torch.cummax(torch.where(new_run, ar, 0), dim=-1).values
    return ar - run_start


def decode_capacity(cfg: ArchConfig, t: int) -> int:
    """Expert buffer depth of the decode dispatch for ``t`` tokens."""
    e, k = cfg.num_experts, cfg.experts_per_token
    factor = cfg.moe_decode_capacity_factor or 4.0
    if cfg.moe_decode_capacity_factor == 0.0 and t <= 256:
        return t                         # dropless for small serving batches
    return min(t, max(k, int(round(t * k / e * factor))))


def _moe_decode_dispatch(params, x, gate_vals, expert_idx, cfg):
    """Decode-regime MoE: flat dispatch over the (tiny) token batch into
    an (E, C, d) expert buffer capped at ``decode_capacity``. The dispatch
    and the combine flatten the batch, so on a mesh they run replicated
    (``on_local(..., rows=False)``)."""
    b, s, d = x.shape
    capacity = decode_capacity(cfg, b * s)
    hbuf, slot, weight, tok = on_local(
        functools.partial(_decode_dispatch, e=cfg.num_experts,
                          capacity=capacity),
        x, gate_vals, expert_idx, rows=False)
    hbuf = constrain(hbuf, "moe_buf_decode")
    hin = einsum("ecd,edf->ecf", hbuf, params["w_in"])
    hg = einsum("ecd,edf->ecf", hbuf, params["w_gate"])
    act = F.silu(hg) * hin
    hout = einsum("ecf,efd->ecd", act, params["w_out"])
    hout = constrain(hout, "moe_buf_decode")
    y = on_local(functools.partial(_decode_combine, t=b * s),
                 hout, slot, weight, tok, rows=False)
    return y.reshape(b, s, d)


def _decode_dispatch(x, gate_vals, expert_idx, *, e: int, capacity: int):
    """The decode dispatch on plain tensors: the (E, C, d) buffer, and
    each (token, choice)'s slot, gate weight (zero where dropped) and
    token."""
    b, s, d = x.shape
    k = expert_idx.shape[-1]
    t = b * s
    tk = t * k
    xf = x.reshape(t, d)
    flat_e = expert_idx.reshape(tk)
    flat_g = gate_vals.reshape(tk)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    se, sg, stok = flat_e[order], flat_g[order], flat_tok[order]
    pos = _run_starts(se)
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, e * capacity)

    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xf[stok] * keep[:, None].to(x.dtype)
    return buf[:-1].reshape(e, capacity, d), slot, sg * keep, stok


def _decode_combine(hout, slot, weight, tok, *, t: int):
    """The decode combine on plain tensors: (T, d), each token's gated
    sum of its experts' outputs."""
    e, capacity, d = hout.shape
    hflat = torch.cat([hout.reshape(e * capacity, d),
                       torch.zeros((1, d), dtype=hout.dtype,
                                   device=hout.device)])
    contrib = hflat[slot] * weight[:, None].to(hout.dtype)
    y = torch.zeros((t, d), dtype=hout.dtype, device=hout.device)
    y.index_add_(0, tok, contrib)
    return y


def row_capacity(cfg: ArchConfig, s: int) -> int:
    """Expert buffer depth of the per-row dispatch for rows of ``s``."""
    tk = s * cfg.experts_per_token
    # Dropless only at serving-scale rows (tk <= 512).
    if tk <= 512 and cfg.moe_capacity_factor >= 1.0:
        return tk
    return int(max(1, round(tk / cfg.num_experts * cfg.moe_capacity_factor)))


def _moe_dispatch_per_row(params, x, gate_vals, expert_idx, cfg):
    """Row-local sort-based dispatch with capacity cap. The dispatch and
    the combine treat each batch row on its own, so on a mesh each rank
    runs them on its rows (``on_local``)."""
    b, s, d = x.shape
    capacity = row_capacity(cfg, s)
    hbuf, slot, weight, tok = on_local(
        functools.partial(_row_dispatch, e=cfg.num_experts,
                          capacity=capacity), x, gate_vals, expert_idx)
    hbuf = constrain(hbuf, "moe_buf")
    hin = einsum("becd,edf->becf", hbuf, params["w_in"])
    hg = einsum("becd,edf->becf", hbuf, params["w_gate"])
    act = F.silu(hg) * hin
    hout = einsum("becf,efd->becd", act, params["w_out"])
    hout = constrain(hout, "moe_buf")
    return on_local(functools.partial(_row_combine, s=s),
                    hout, slot, weight, tok)


def _row_dispatch(x, gate_vals, expert_idx, *, e: int, capacity: int):
    """The per-row dispatch on plain tensors: the (B, E, C, d) buffer,
    and each row's (token, choice) slots, gate weights (zero where
    dropped) and token indices within the row."""
    b, s, d = x.shape
    k = expert_idx.shape[-1]
    tk = s * k
    flat_e = expert_idx.reshape(b, tk)
    flat_g = gate_vals.reshape(b, tk)
    flat_tok = torch.arange(s, device=x.device).repeat_interleave(k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices   # (B, tk)
    se = torch.gather(flat_e, 1, order)
    sg = torch.gather(flat_g, 1, order)
    stok = flat_tok[order]
    pos = _run_starts(se)
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, e * capacity)  # (B, tk)

    rows = torch.arange(b, device=x.device)[:, None]
    gathered = x[rows, stok] * keep[..., None].to(x.dtype)      # (B,tk,d)
    buf = torch.zeros((b, e * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[rows, slot] = gathered
    return buf[:, :-1].reshape(b, e, capacity, d), slot, sg * keep, stok


def _row_combine(hout, slot, weight, tok, *, s: int):
    """The per-row combine on plain tensors: (B, S, d), each token's
    gated sum of its experts' outputs."""
    b, e, capacity, d = hout.shape
    hflat = torch.cat([hout.reshape(b, e * capacity, d),
                       torch.zeros((b, 1, d), dtype=hout.dtype,
                                   device=hout.device)], dim=1)
    rows = torch.arange(b, device=hout.device)[:, None]
    contrib = hflat[rows, slot] * weight[..., None].to(hout.dtype)
    y = torch.zeros((b * s, d), dtype=hout.dtype, device=hout.device)
    y.index_add_(0, (rows * s + tok).reshape(-1), contrib.reshape(-1, d))
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

class SSMState(NamedTuple):
    h: torch.Tensor     # (B, H, P, N) recurrent state, float32 or wider
    conv: torch.Tensor  # (B, conv_dim, W-1) rolling conv window


def init_mamba2(gen, cfg: ArchConfig, dtype, device=None) -> Params:
    d, d_in = cfg.d_model, cfg.d_inner
    n, h, w = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    conv_dim = d_in + 2 * n
    f32 = torch.float32
    return Params(
        # projects to [z (gate), x, B, C, dt]
        w_in=_init(gen, (d, 2 * d_in + 2 * n + h), dtype=dtype,
                   device=device),
        conv_w=_init(gen, (conv_dim, w), scale=0.5, dtype=dtype,
                     device=device),
        conv_b=_zeros((conv_dim,), dtype, gen, device),
        # the decay, skip and step parameters stay float32
        a_log=_zeros((h,), f32, gen, device),
        d_skip=_ones((h,), f32, gen, device),
        dt_bias=_zeros((h,), f32, gen, device),
        out_norm=_ones((d_in,), dtype, gen, device),
        w_out=_init(gen, (d_in, d), dtype=dtype, device=device))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Segment sums, masked for ``exp``: a (..., Q) -> (..., Q, Q) with
    [i, j] = sum_{l=j+1..i} a_l = cs[i] - cs[j] for i >= j and -inf
    above the diagonal. The mask comes before ``exp``, so nothing above
    the diagonal overflows and its gradient is zero, not NaN."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), with no switch to the identity for large x as
    ``F.softplus``'s ``threshold`` makes."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv(windows, conv_w, conv_b, dtype):
    """The prefill's depthwise causal conv: sum_w windows[w] * conv_w[:, w]
    + conv_b in float32 (or wider), then SiLU, in ``dtype``. ``windows``
    is the W taps, each (B, S, conv_dim): shifted views, so no (B, S,
    conv_dim, W) tensor is made."""
    acc = conv_b.to(torch.promote_types(conv_b.dtype, torch.float32))
    for i, tap in enumerate(windows):
        acc = acc + wide(tap) * conv_w[:, i]
    return F.silu(acc.to(dtype))


def mamba2_mix(params, x: torch.Tensor, cfg: ArchConfig, *,
               state: Optional[SSMState] = None,
               return_state: bool = False):
    """Chunked SSD for prefill; the one-step recurrence for decode.

    Branches, as the reference's:
      - ``state`` given and one token: the rolling conv and one
        recurrence step;
      - otherwise the causal conv (padded with zeros, or continuing
        ``state.conv``) and the chunked SSD over chunks of
        ``min(ssm_chunk, s)`` tokens (``s`` must divide), from zeros or
        from ``state.h``: the intra-chunk product, each chunk's end
        state, and a loop over chunks carrying the state between them.

    Where ``state`` is given its tensors are updated in place (the
    port's cache convention) and it is returned; else, with
    ``return_state``, a new ``SSMState``. The four-operand products of
    the reference are written as pairwise ones; the decays, the states
    and the recurrence run in float32 (or wider).
    """
    b, s, _ = x.shape
    d_in, n = cfg.d_inner, cfg.ssm_state
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.ssm_conv_width

    zxbcdt = einsum("bsd,de->bse", x, params["w_in"])
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [d_in, d_in, n, n, h],
                                         dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)         # (B,S,conv_dim)
    a = -torch.exp(params["a_log"])                        # (H,)

    if state is not None and s == 1:
        # --- decode: rolling conv + one recurrence step ------------------
        window = torch.cat([state.conv, conv_in.transpose(1, 2)], -1)
        acc = (wide(window) * params["conv_w"]).sum(-1) + params["conv_b"]
        conv_out = F.silu(acc.to(x.dtype))                 # (B, conv_dim)
        xin_c, b_c, c_c = torch.split(conv_out, [d_in, n, n], dim=-1)
        xh = wide(xin_c.reshape(b, h, p))
        dt_s = _softplus(wide(dt[:, 0]) + params["dt_bias"])   # (B, H)
        decay = torch.exp(dt_s * a)                        # (B, H)
        dbx = (dt_s[:, :, None] * xh)[..., None] * wide(b_c)[:, None, None]
        h_new = state.h * decay[:, :, None, None] + dbx    # (B,H,P,N)
        y = (h_new * wide(c_c)[:, None, None]).sum(-1)     # (B,H,P)
        y = y + params["d_skip"][None, :, None] * xh
        y = y.reshape(b, 1, d_in).to(x.dtype)
        state.conv.copy_(window[:, :, 1:])
        state.h.copy_(h_new)
        new_state = state
    else:
        # --- prefill: causal conv + chunked SSD --------------------------
        pad = conv_in.new_zeros((b, w - 1, conv_in.shape[-1])) \
            if state is None else state.conv.transpose(1, 2)
        seq = torch.cat([pad, conv_in], dim=1)           # (B,S+W-1,C)
        conv_out = _conv([seq[:, i:i + s] for i in range(w)],
                         params["conv_w"], params["conv_b"], x.dtype)
        xin_c, b_c, c_c = torch.split(conv_out, [d_in, n, n], dim=-1)

        q = min(cfg.ssm_chunk, s)
        assert s % q == 0, f"seq {s} must be divisible by ssm_chunk {q}"
        nc = s // q
        xh = wide(xin_c.reshape(b, nc, q, h, p))
        bm = wide(b_c.reshape(b, nc, q, n))
        cm = wide(c_c.reshape(b, nc, q, n))
        dt_s = _softplus(wide(dt.reshape(b, nc, q, h)) + params["dt_bias"])
        da_h = (dt_s * a).movedim(-1, 2)                   # (B,NC,H,Q)
        xdt = xh * dt_s[..., None]                         # x scaled by dt

        # intra-chunk: (C_q . B_s) L[q, s] (dt x)_s
        lmat = torch.exp(_segsum(da_h))                    # (B,NC,H,Q,Q)
        cb = einsum("bcqn,bcsn->bcqs", cm, bm)             # (B,NC,Q,Q)
        y_diag = einsum("bchqs,bcshp->bcqhp", cb[:, :, None] * lmat, xdt)

        # each chunk's end state, and the states entering the chunks
        cum = torch.cumsum(da_h, dim=-1)                   # (B,NC,H,Q)
        decay_states = torch.exp(cum[..., -1:] - cum)      # (B,NC,H,Q)
        chunk_states = einsum(
            "bcqn,bcqhp->bchpn", bm,
            xdt * decay_states.transpose(2, 3)[..., None])  # (B,NC,H,P,N)
        chunk_decay = torch.exp(cum[..., -1])              # (B,NC,H)
        carry = state.h if state is not None else torch.zeros(
            (b, h, p, n), dtype=xh.dtype, device=x.device)
        h_prevs = []
        for c in range(nc):                 # the reference's lax.scan
            h_prevs.append(carry)
            carry = carry * chunk_decay[:, c, :, None, None] \
                + chunk_states[:, c]
        h_prev = torch.stack(h_prevs, dim=1)               # (B,NC,H,P,N)

        state_decay = torch.exp(cum)                       # (B,NC,H,Q)
        y_off = einsum("bcqn,bchpn->bcqhp", cm, h_prev) \
            * state_decay.transpose(2, 3)[..., None]
        y = (y_diag + y_off).reshape(b, s, h, p)
        y = y + params["d_skip"][None, None, :, None] * xh.reshape(b, s, h, p)
        y = y.reshape(b, s, d_in).to(x.dtype)
        new_conv = seq[:, -(w - 1):, :].transpose(1, 2)
        if state is not None:
            state.conv.copy_(new_conv)
            state.h.copy_(carry)
            new_state = state
        else:
            new_state = SSMState(h=carry, conv=new_conv.contiguous()) \
                if return_state else None

    y = rmsnorm(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, params["w_out"])
    return out, new_state
