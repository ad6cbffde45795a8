"""Model factory: init / forward / decode for the decoder families (the
port of the reference's ``models/model.py``).

Families ported:
  dense   : [attn -> mlp] x L     (yi, starcoder2, minicpm3 w/ MLA)
  moe     : [attn -> moe] x L     (moonshot)

The reference's ``ssm``, ``hybrid``, ``encdec`` and ``vlm`` families are
reached by no registered config; here they raise NotImplementedError
(ROADMAP Queue 1).

Each block runs under the config's ``remat`` policy when autograd records
it (``_maybe_remat``); decode and ``torch.no_grad()`` run it plainly.

Parameters are ``layers.Params`` modules named as the reference's dicts:
``embed``, ``final_norm``, ``lm_head`` and ``layers.<i>.{ln1, attn.*, ln2,
mlp.* | moe.*}``. The layers are always a list (the reference's
unstacked ``scan_layers=False`` layout); ``interop.lm_params_from_numpy``
loads either of the reference's layouts. Caches are stacked over layers,
(L, ...), as in the reference, and the cache index is a host integer.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding_hooks import constrain, einsum

FAMILIES = ("dense", "moe")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}[cfg.dtype]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported; the port "
            f"runs {FAMILIES} (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchConfig, dtype, device=None) -> L.Params:
    """One decoder block's params."""
    d = cfg.d_model
    attn = (L.init_mla(gen, cfg, dtype, device) if cfg.attention == "mla"
            else L.init_gqa(gen, cfg, dtype, device))
    p: Dict[str, Any] = dict(ln1=L._ones((d,), dtype, gen, device),
                             attn=attn,
                             ln2=L._ones((d,), dtype, gen, device))
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype, device)
    return L.Params(**p)


def _build(cfg: ArchConfig, gen: Optional[torch.Generator],
           device) -> L.Params:
    _check_family(cfg)
    dtype = _dtype(cfg)
    p: Dict[str, Any] = dict(
        embed=L._init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02,
                      dtype=dtype, device=device),
        final_norm=L._ones((cfg.d_model,), dtype, gen, device))
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (cfg.d_model, cfg.vocab_size),
                               dtype=dtype, device=device)
    p["layers"] = nn.ModuleList(_init_block(gen, cfg, dtype, device)
                                for _ in range(cfg.num_layers))
    return L.Params(**p)


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device="cuda") -> L.Params:
    """Random weights from the reference's distributions: normal x
    1/sqrt(shape[0]) (``embed`` and ``router`` x 0.02, ``wo`` x
    1/sqrt(h*k)), norms at one. Drawn by a generator on ``device`` seeded
    with ``seed``, so the draws are not the reference's (``jax.random``);
    parity goes through ``interop.lm_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _build(cfg, gen, dev)


def empty_params(cfg: ArchConfig, *, device="cuda") -> L.Params:
    """The parameter layout of ``init_params``, uninitialised."""
    return _build(cfg, None, resolve_device(device))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """The reference's union cache. Only ``kv`` (stacked ``KVCache`` or
    ``MLACache``, (L, ...)) is used by the ported families; the other
    cache fields stay None."""

    kv: Optional[Any]
    ssm: Optional[Any]
    shared_kv: Optional[Any]
    enc_out: Optional[torch.Tensor]
    cross_kv: Optional[Any]
    index: int                 # next write position, one for the batch


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device="cuda") -> DecodeCache:
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    n_l = cfg.num_layers
    if cfg.attention == "mla":
        kv = L.MLACache(
            c_kv=torch.zeros((n_l, batch, max_seq, cfg.kv_lora_rank),
                             dtype=dtype, device=dev),
            k_rope=torch.zeros((n_l, batch, max_seq, cfg.rope_head_dim),
                               dtype=dtype, device=dev))
    else:
        shape = (n_l, batch, cfg.num_kv_heads, max_seq,
                 cfg.resolved_head_dim)
        kv = L.KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev))
    return DecodeCache(kv=kv, ssm=None, shared_kv=None, enc_out=None,
                       cross_kv=None, index=0)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(p, x, positions, cfg: ArchConfig, *, cache=None,
                 cache_index=None, return_cache=False):
    """One decoder block. Returns (x, new_kv, aux_loss)."""
    x = constrain(x, "residual")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attend = L.mla_attention if cfg.attention == "mla" else L.gqa_attention
    y, new_kv = attend(p["attn"], h, positions, cfg, cache=cache,
                       cache_index=cache_index, return_cache=return_cache)
    x = x + y
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = L.moe_block(p["moe"], h, cfg)
    else:
        y = L.mlp(p["mlp"], h, cfg.mlp_type)
    return x + y, new_kv, aux


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the products
    with no batch dimension, recompute the rest (JAX's
    ``checkpoint_dots_with_no_batch_dims``). ``torch.einsum`` lowers a
    product with no batch dimension (the weight products, such as
    ``bsd,dhk->bshk``) to a ``bmm`` of batch 1, and attention's and the
    MoE experts' products to a ``bmm`` over their batch dimensions; one
    of those is kept too where its batch is 1 (attention at batch 1 with
    one kv group)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` under the config's rematerialization policy (the port of the
    reference's ``_maybe_remat``): ``"none"`` runs it as is, ``"full"``
    (or any other value, as there) keeps only its inputs and runs it
    again in the backward, ``"dots"`` also keeps its weight products."""
    if cfg.remat == "none":
        return fn
    kwargs = dict(use_reentrant=False)
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, **kwargs)


def _stack(caches):
    """Per-layer caches -> one cache stacked over layers (L, ...)."""
    return type(caches[0])(*(torch.stack(xs) for xs in zip(*caches)))


def _run_layers(params, x, positions, cfg: ArchConfig, *,
                build_cache=False):
    """Run the decoder stack. Returns (x, stacked kv caches or None,
    total aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    block = _apply_block
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in params.parameters())):
        block = _maybe_remat(_apply_block, cfg)
    for lp in params["layers"]:
        x, kv, a = block(lp, x, positions, cfg, return_cache=build_cache)
        aux = aux + a
        if kv is not None:
            kvs.append(kv)
    return x, (_stack(kvs) if kvs else None), aux


def _logits(params, x, cfg: ArchConfig):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return einsum("bsd,dv->bsv", x, head)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, build_cache: bool = False):
    """Full forward over a token batch ``{"tokens": (B, S) int}``.

    Returns (logits (B, S, V), aux_loss, cache or None).
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens).to(_dtype(cfg))
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, kv, aux = _run_layers(params, x, positions, cfg,
                             build_cache=build_cache)
    cache = None
    if build_cache:
        cache = DecodeCache(kv=kv, ssm=None, shared_kv=None, enc_out=None,
                            cross_kv=None, index=s)
    return _logits(params, x, cfg), aux, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params, tokens: torch.Tensor, cache: DecodeCache,
                cfg: ArchConfig):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), new cache).

    Writes each layer's new K/V into ``cache``'s tensors in place at
    ``cache.index`` and returns the cache with the index advanced. As in
    the reference, a write at or past ``max_seq`` is dropped and the step
    attends over the whole cache.
    """
    _check_family(cfg)
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(_dtype(cfg))
    idx = cache.index
    positions = torch.full((b, 1), idx, dtype=torch.int64, device=x.device)
    kv = cache.kv
    for i, lp in enumerate(params["layers"]):
        layer_kv = type(kv)(*(a[i] for a in kv))
        x, _, _ = _apply_block(lp, x, positions, cfg, cache=layer_kv,
                               cache_index=idx)
    return _logits(params, x, cfg), cache._replace(index=idx + 1)
