"""Serving steps: prefill + decode (the port of the reference's
``train/serve_step.py``).

``prefill`` runs the full forward, builds the KV/SSM caches and pads them
to ``max_seq`` so the decode loop keeps one shape. ``decode`` emits one
token per call; greedy sampling built in for the serving example.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.layers import KVCache, MLACache


def _pad_cache_seq(cache: M.DecodeCache, max_seq: int) -> M.DecodeCache:
    """Grow kv caches built at prompt length to the serving window."""
    def pad_axis(a, axis):
        if a.shape[axis] >= max_seq:
            return a
        shape = list(a.shape)
        shape[axis] = max_seq - a.shape[axis]
        return torch.cat([a, a.new_zeros(shape)], dim=axis)

    kv = cache.kv
    if isinstance(kv, KVCache):
        kv = KVCache(k=pad_axis(kv.k, 3), v=pad_axis(kv.v, 3))
    elif isinstance(kv, MLACache):
        kv = MLACache(c_kv=pad_axis(kv.c_kv, 2),
                      k_rope=pad_axis(kv.k_rope, 2))
    shared = cache.shared_kv
    if isinstance(shared, KVCache):
        shared = KVCache(k=pad_axis(shared.k, 3), v=pad_axis(shared.v, 3))
    return cache._replace(kv=kv, shared_kv=shared)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, M.DecodeCache]:
    """Returns (logits (B,S,V), cache ready for decode). Raises for the
    hybrid family, as the reference does: its forward's cache holds the
    shared block's K/V under ``kv``, not the decode layout."""
    logits, _, cache = M.forward(params, batch, cfg, build_cache=True)
    if cfg.family == "hybrid":
        # hybrid prefill rebuilds per-invocation caches via decode layout
        raise NotImplementedError(
            "hybrid prefill->decode chaining uses serve loop in "
            "examples/serve_lm.py (cache built by forward covers kv only)")
    if max_seq is not None:
        cache = _pad_cache_seq(cache, max_seq)
    return logits, cache


def decode(params, tokens: torch.Tensor, cache: M.DecodeCache,
           cfg: ArchConfig) -> Tuple[torch.Tensor, M.DecodeCache]:
    """One decode step: tokens (B,1) -> (logits (B,1,V), updated cache)."""
    return M.decode_step(params, tokens, cache, cfg)


def greedy_generate(params, prompt: torch.Tensor, cfg: ArchConfig, *,
                    max_new: int, max_seq: int) -> torch.Tensor:
    """Batched greedy generation: prompt (B, S) -> (B, max_new) ids, for
    the decoder-only families (dense, moe); the others raise, as in the
    reference."""
    _, s = prompt.shape
    if cfg.family in ("ssm", "hybrid", "encdec", "vlm"):
        raise NotImplementedError("example loop targets decoder-only LMs")
    logits, cache = prefill(params, {"tokens": prompt}, cfg, max_seq=max_seq)
    next_tok = torch.argmax(logits[:, -1:, :], dim=-1)
    cache = cache._replace(index=s)
    toks = [next_tok]
    for _ in range(max_new - 1):
        logits, cache = M.decode_step(params, next_tok, cache, cfg)
        next_tok = torch.argmax(logits, dim=-1)
        toks.append(next_tok)
    return torch.cat(toks, dim=1)
