"""Model factory: init / forward / decode for every family (the port of
the reference's ``models/model.py``).

Families:
  dense   : [attn -> mlp] x L     (yi, starcoder2, minicpm3 w/ MLA)
  moe     : [attn -> moe] x L     (moonshot)
  ssm     : [mamba2] x L          (mamba2-780m)
  hybrid  : mamba2 x L + one shared attn block after every k  (zamba2)
  encdec  : encoder [attn -> mlp] + decoder with cross-attn (whisper; a
            stub frontend supplies the frame embeddings)
  vlm     : projected vision-prefix embeddings + dense decoder
            (internvl2; a stub frontend supplies the patch embeddings)

The registry (``configs.ARCH_IDS``) holds dense and moe configs only;
the other four families run from configs built by the caller.

Each block (hybrid: each group of blocks with its shared block; encdec:
each encoder block too) runs under the config's ``remat`` policy when
autograd records it (``_maybe_remat``); decode and ``torch.no_grad()``
run it plainly.

Parameters are ``layers.Params`` modules named as the reference's dicts:
``embed``, ``final_norm``, ``lm_head`` and ``layers.<i>.{ln1, attn.*, ln2,
mlp.* | moe.*, ln_x, xattn.* | ssm.*}``, with ``shared_attn.*``,
``encoder.<i>.*`` + ``enc_final_norm`` and ``vision_proj`` where the
family has them. The layers (and the encoder's) are always a list (the
reference's unstacked ``scan_layers=False`` layout);
``interop.lm_params_from_numpy`` loads either of the reference's
layouts. Caches are stacked over layers, (L, ...), as in the reference,
and the cache index is a host integer.
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

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
_ATTENTION = ("dense", "moe", "vlm", "encdec")       # attention blocks
_MAMBA = ("ssm", "hybrid")                            # Mamba2 blocks


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}[cfg.dtype]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not one of {FAMILIES}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchConfig, dtype, device=None) -> L.Params:
    """One decoder block's params."""
    d = cfg.d_model
    if cfg.family in _MAMBA:
        return L.Params(ln1=L._ones((d,), dtype, gen, device),
                        ssm=L.init_mamba2(gen, cfg, dtype, device))
    attn = (L.init_mla(gen, cfg, dtype, device) if cfg.attention == "mla"
            else L.init_gqa(gen, cfg, dtype, device))
    p: Dict[str, Any] = dict(ln1=L._ones((d,), dtype, gen, device),
                             attn=attn,
                             ln2=L._ones((d,), dtype, gen, device))
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype, device)
    if cfg.family == "encdec":
        p["ln_x"] = L._ones((d,), dtype, gen, device)
        p["xattn"] = L.init_gqa(gen, cfg, dtype, device)
    return L.Params(**p)


def _init_attn_mlp(gen, cfg: ArchConfig, dtype, device, d_ff: int,
                   mlp_type: str) -> L.Params:
    """An attention + MLP block: Zamba2's shared block and Whisper's
    encoder blocks."""
    d = cfg.d_model
    return L.Params(ln1=L._ones((d,), dtype, gen, device),
                    attn=L.init_gqa(gen, cfg, dtype, device),
                    ln2=L._ones((d,), dtype, gen, device),
                    mlp=L.init_mlp(gen, d, d_ff, mlp_type, dtype, device))


def _build(cfg: ArchConfig, gen: Optional[torch.Generator],
           device) -> L.Params:
    _check_family(cfg)
    dtype = _dtype(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = dict(
        embed=L._init(gen, (cfg.vocab_size, d), scale=0.02,
                      dtype=dtype, device=device),
        final_norm=L._ones((d,), dtype, gen, device))
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (d, cfg.vocab_size),
                               dtype=dtype, device=device)
    p["layers"] = nn.ModuleList(_init_block(gen, cfg, dtype, device)
                                for _ in range(cfg.num_layers))
    if cfg.family == "hybrid":
        p["shared_attn"] = _init_attn_mlp(
            gen, cfg, dtype, device, cfg.shared_attn_d_ff or cfg.d_ff,
            "swiglu")
    if cfg.family == "encdec":
        p["encoder"] = nn.ModuleList(
            _init_attn_mlp(gen, cfg, dtype, device, cfg.d_ff, cfg.mlp_type)
            for _ in range(cfg.encoder_layers))
        p["enc_final_norm"] = L._ones((d,), dtype, gen, device)
    if cfg.family == "vlm":
        p["vision_proj"] = L._init(gen, (d, d), dtype=dtype, device=device)
    return L.Params(**p)


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device="cuda") -> L.Params:
    """Random weights from the reference's distributions: normal x
    1/sqrt(shape[0]) (``embed`` and ``router`` x 0.02, ``wo`` x
    1/sqrt(h*k), ``conv_w`` x 0.5), norms and ``d_skip`` at one,
    ``conv_b``, ``a_log`` and ``dt_bias`` at zero. Drawn by a generator
    on ``device`` seeded with ``seed``, so the draws are not the
    reference's (``jax.random``); parity goes through
    ``interop.lm_params_from_numpy``."""
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
    """The reference's union cache; a family's unused fields are None."""

    kv: Optional[Any]          # stacked KVCache or MLACache (L, ...)
    ssm: Optional[Any]         # stacked SSMState (L, ...)
    shared_kv: Optional[Any]   # KVCache (L // shared_attn_every, ...)
    enc_out: Optional[torch.Tensor]   # (B, enc_seq, D) encoder output
    cross_kv: Optional[Any]    # KVCache (L, B, G, enc_seq, K) precomputed
    index: int                 # next write position, one for the batch


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               enc_out: Optional[torch.Tensor] = None,
               with_cross_kv: bool = True, device="cuda") -> DecodeCache:
    """Zeroed decode buffers for ``cfg``'s family, as the reference's: KV
    (or MLA latents) for the attention families, the SSM state and conv
    window for ssm / hybrid, the shared block's KV for each of hybrid's
    groups, and encdec's cross K/V (``with_cross_kv``) over
    ``encoder_seq`` positions. ``enc_out`` is carried as given. The SSM
    state ``h`` is float32 (or the model's dtype where that is wider)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    n_l = cfg.num_layers
    kv = ssm = shared = cross = None

    def kv_buf(n, seq):
        shape = (n, batch, cfg.num_kv_heads, seq, cfg.resolved_head_dim)
        return L.KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                         v=torch.zeros(shape, dtype=dtype, device=dev))

    if cfg.family == "encdec" and with_cross_kv:
        cross = kv_buf(n_l, cfg.encoder_seq)
    if cfg.family in _ATTENTION:
        if cfg.attention == "mla":
            kv = L.MLACache(
                c_kv=torch.zeros((n_l, batch, max_seq, cfg.kv_lora_rank),
                                 dtype=dtype, device=dev),
                k_rope=torch.zeros((n_l, batch, max_seq, cfg.rope_head_dim),
                                   dtype=dtype, device=dev))
        else:
            kv = kv_buf(n_l, max_seq)
    if cfg.family in _MAMBA:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        ssm = L.SSMState(
            h=torch.zeros((n_l, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state),
                          dtype=torch.promote_types(dtype, torch.float32),
                          device=dev),
            conv=torch.zeros((n_l, batch, conv_dim, cfg.ssm_conv_width - 1),
                             dtype=dtype, device=dev))
    if cfg.family == "hybrid":
        shared = kv_buf(cfg.num_layers // cfg.shared_attn_every, max_seq)
    return DecodeCache(kv=kv, ssm=ssm, shared_kv=shared, enc_out=enc_out,
                       cross_kv=cross, index=0)


def _layer(cache, i: int):
    """Entry ``i`` of a cache stacked on axis 0 (views: writes into it
    land in the stack), or None."""
    return None if cache is None else type(cache)(*(a[i] for a in cache))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(p, x, positions, cfg: ArchConfig, *, cache=None,
                 cache_index=None, return_cache=False, enc_out=None,
                 ssm_state=None, cross_kv=None):
    """One decoder block. Returns (x, new_kv, new_ssm, aux_loss).

    encdec's cross-attention takes the precomputed ``cross_kv`` where
    given, else projects ``enc_out``; a Mamba2 block continues
    ``ssm_state`` where given (in place)."""
    x = constrain(x, "residual")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.family in _MAMBA:
        y, new_ssm = L.mamba2_mix(
            p["ssm"], h, cfg, state=ssm_state,
            return_state=return_cache or ssm_state is not None)
        return x + y, None, new_ssm, aux
    attend = L.mla_attention if cfg.attention == "mla" else L.gqa_attention
    y, new_kv = attend(p["attn"], h, positions, cfg, cache=cache,
                       cache_index=cache_index, return_cache=return_cache)
    x = x + y
    if cfg.family == "encdec":
        h = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
        if cross_kv is not None:
            y, _ = L.gqa_attention(p["xattn"], h, positions, cfg,
                                   causal=False, static_kv=cross_kv)
        else:
            y, _ = L.gqa_attention(p["xattn"], h, positions, cfg,
                                   causal=False, kv_x=enc_out)
        x = x + y
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = L.moe_block(p["moe"], h, cfg)
    else:
        y = L.mlp(p["mlp"], h, cfg.mlp_type)
    return x + y, new_kv, None, aux


def _apply_shared_attn(p, x, positions, cfg: ArchConfig, *, cache=None,
                       cache_index=None, return_cache=False):
    """Zamba2's shared attention + SwiGLU block. Returns (x, new_kv)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, new_kv = L.gqa_attention(p["attn"], h, positions, cfg, cache=cache,
                                cache_index=cache_index,
                                return_cache=return_cache)
    x = x + y
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, "swiglu"), new_kv


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


def _records(params, x) -> bool:
    """Whether autograd records this forward (then blocks run under the
    config's remat policy)."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for p in params.parameters()))


def _run_layers(params, x, positions, cfg: ArchConfig, *,
                build_cache=False, enc_out=None):
    """Run the decoder stack. Returns (x, stacked kv caches, stacked SSM
    states, total aux loss, stacked cross K/V); the caches are None
    unless ``build_cache``."""
    if cfg.family == "hybrid":
        return _run_layers_hybrid(params, x, positions, cfg,
                                  build_cache=build_cache)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs, ssms, cross = [], [], []
    block = _apply_block
    if _records(params, x):
        block = _maybe_remat(_apply_block, cfg)
    for lp in params["layers"]:
        x, kv, ssm, a = block(lp, x, positions, cfg,
                              return_cache=build_cache, enc_out=enc_out)
        aux = aux + a
        if kv is not None:
            kvs.append(kv)
        if ssm is not None:
            ssms.append(ssm)
        if build_cache and cfg.family == "encdec":
            # this layer's cross-attention K/V, projected once for decode
            cross.append(L.KVCache(
                einsum("btd,dgk->bgtk", enc_out, lp["xattn"]["wk"]),
                einsum("btd,dgk->bgtk", enc_out, lp["xattn"]["wv"])))
    return (x, _stack(kvs) if kvs else None, _stack(ssms) if ssms else None,
            aux, _stack(cross) if cross else None)


def _run_layers_hybrid(params, x, positions, cfg: ArchConfig, *,
                       build_cache=False):
    """Zamba2: groups of ``shared_attn_every`` Mamba2 layers, each
    followed by the shared attention block (the same parameters every
    time), then the layers past the last full group. Each group runs
    under the remat policy where autograd records, as the reference's
    group body; the tail does not.

    Under ``build_cache`` it returns the shared block's K/V of each
    group as the ``kv`` (the reference's layout: ``forward`` puts it
    under ``kv`` and leaves ``shared_kv`` None, which decode reads, so
    prefill -> decode is not chained for this family)."""
    k = cfg.shared_attn_every
    n_groups = cfg.num_layers // k
    layers = list(params["layers"])
    shared = params["shared_attn"]

    def group(h, lps):
        states = []
        for lp in lps:
            h, _, st, _ = _apply_block(lp, h, positions, cfg,
                                       return_cache=build_cache)
            states.append(st)
        h, kv = _apply_shared_attn(shared, h, positions, cfg,
                                   return_cache=build_cache)
        return h, kv, states

    if _records(params, x):
        group = _maybe_remat(group, cfg)
    kvs, ssms = [], []
    for g in range(n_groups):
        x, kv, states = group(x, layers[g * k:(g + 1) * k])
        kvs.append(kv)
        ssms.extend(states)
    for lp in layers[n_groups * k:]:
        x, _, st, _ = _apply_block(lp, x, positions, cfg,
                                   return_cache=build_cache)
        ssms.append(st)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not build_cache:
        return x, None, None, aux, None
    return x, _stack(kvs) if kvs else None, _stack(ssms), aux, None


def _encode(params, frames, cfg: ArchConfig):
    """The encoder over the stub frontend's frame embeddings: blocks of
    non-causal self-attention (RoPE over the frame positions) and MLP,
    each under the remat policy where autograd records, then
    ``enc_final_norm``."""
    b, t, _ = frames.shape
    pos = torch.arange(t, device=frames.device)[None].expand(b, t)

    def body(h, lp):
        y, _ = L.gqa_attention(lp["attn"], L.rmsnorm(lp["ln1"], h,
                                                     cfg.norm_eps),
                               pos, cfg, causal=False)
        h = h + y
        return h + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], h, cfg.norm_eps),
                         cfg.mlp_type)

    if _records(params, frames):
        body = _maybe_remat(body, cfg)
    x = frames
    for lp in params["encoder"]:
        x = body(x, lp)
    return L.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps)


def _logits(params, x, cfg: ArchConfig):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return einsum("bsd,dv->bsv", x, head)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, build_cache: bool = False):
    """Full forward over a token batch ``{"tokens": (B, S) int}``, with
    ``"frames"`` (B, encoder_seq, D) for encdec and ``"vision"`` (B, V,
    D) for vlm (the stub frontends' embeddings).

    vlm prepends the projected vision embeddings; the logits cover the
    tokens only, and the cache's index is S + V. encdec's cache carries
    the encoder output and every layer's cross K/V.

    Returns (logits (B, S, V), aux_loss, cache or None).
    """
    _check_family(cfg)
    dtype = _dtype(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens).to(dtype)
    enc_out, offset = None, 0
    if cfg.family == "encdec":
        enc_out = _encode(params, batch["frames"].to(dtype), cfg)
    if cfg.family == "vlm":
        vis = einsum("bvd,de->bve", batch["vision"].to(dtype),
                     params["vision_proj"])
        x = torch.cat([vis, x], dim=1)
        offset = vis.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(
        b, x.shape[1])
    x, kv, ssm, aux, cross = _run_layers(params, x, positions, cfg,
                                         build_cache=build_cache,
                                         enc_out=enc_out)
    cache = None
    if build_cache:
        cache = DecodeCache(kv=kv, ssm=ssm, shared_kv=None, enc_out=enc_out,
                            cross_kv=cross, index=s + offset)
    if offset:                          # vlm: logits for the tokens only
        x = x[:, offset:]
    return _logits(params, x, cfg), aux, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params, tokens: torch.Tensor, cache: DecodeCache,
                cfg: ArchConfig):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), new cache).

    Writes each layer's new K/V, SSM state and conv window into
    ``cache``'s tensors in place at ``cache.index`` and returns the cache
    with the index advanced. As in the reference, a K/V write at or past
    ``max_seq`` is dropped and the step attends over the whole cache.
    encdec attends over ``cache.cross_kv`` where it is set, else over
    ``cache.enc_out`` projected anew.
    """
    _check_family(cfg)
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(_dtype(cfg))
    idx = cache.index
    positions = torch.full((b, 1), idx, dtype=torch.int64, device=x.device)
    if cfg.family == "hybrid":
        x = _decode_hybrid(params, x, positions, cache, cfg)
    else:
        for i, lp in enumerate(params["layers"]):
            x, _, _, _ = _apply_block(
                lp, x, positions, cfg, cache=_layer(cache.kv, i),
                cache_index=idx, enc_out=cache.enc_out,
                ssm_state=_layer(cache.ssm, i),
                cross_kv=_layer(cache.cross_kv, i))
    return _logits(params, x, cfg), cache._replace(index=idx + 1)


def _decode_hybrid(params, x, positions, cache: DecodeCache, cfg):
    """Zamba2's decode: each group's Mamba2 layers on their states, then
    the shared block on that group's entry of ``cache.shared_kv``; then
    the tail's layers."""
    k = cfg.shared_attn_every
    n_groups = cfg.num_layers // k
    layers = list(params["layers"])
    for i, lp in enumerate(layers):
        x, _, _, _ = _apply_block(lp, x, positions, cfg,
                                  ssm_state=_layer(cache.ssm, i))
        if i < n_groups * k and (i + 1) % k == 0:
            x, _ = _apply_shared_attn(
                params["shared_attn"], x, positions, cfg,
                cache=_layer(cache.shared_kv, i // k),
                cache_index=cache.index)
    return x
