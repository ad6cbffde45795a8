"""Carry weights and state into and out of the port as numpy arrays.

The reference's scenes, cameras, frame states, LM parameter trees, train
states and decode caches reach the port as numpy arrays (``np.asarray``
on each field), so the port never sees an object of another framework;
``to_numpy`` converts the port's results back for comparison.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.pipeline import FrameState
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def scene_from_numpy(means, log_scales, quats, opacity_logits, sh, *,
                     device="cuda") -> GaussianScene:
    """GaussianScene of float32 tensors on ``device``."""
    dev = resolve_device(device)
    return GaussianScene(*(_tensor(x, torch.float32, dev) for x in
                           (means, log_scales, quats, opacity_logits, sh)))


def camera_from_numpy(w2c, fx: float, fy: float, cx: float, cy: float,
                      width: int, height: int, *, device="cuda") -> Camera:
    """Camera with a (4, 4) float32 pose on ``device``."""
    return Camera(w2c=_tensor(w2c, torch.float32, resolve_device(device)),
                  fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                  width=int(width), height=int(height))


def frame_state_from_numpy(rgb, exp_depth, trunc_depth, source_mask,
                           frame_idx, contrib: Optional[Any] = None, *,
                           device="cuda") -> FrameState:
    """FrameState on ``device`` (bool mask, int32 frame index)."""
    dev = resolve_device(device)
    return FrameState(
        rgb=_tensor(rgb, torch.float32, dev),
        exp_depth=_tensor(exp_depth, torch.float32, dev),
        trunc_depth=_tensor(trunc_depth, torch.float32, dev),
        source_mask=_tensor(source_mask, torch.bool, dev),
        frame_idx=_tensor(frame_idx, torch.int32, dev),
        contrib=None if contrib is None
        else _tensor(contrib, torch.float32, dev))


def _leaf(x, dev) -> torch.Tensor:
    """One numpy leaf as a tensor of the same dtype. ``np.asarray`` gives
    a bfloat16 leaf as an ``ml_dtypes`` array, which ``torch.tensor``
    rejects; it passes through float32, which holds bfloat16 exactly."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32),
                            device=dev).to(torch.bfloat16)
    return torch.tensor(a, device=dev)


def _flatten(tree, prefix="") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _unstack(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _named_leaves(tree: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A reference parameter-shaped tree (either layer layout) as
    {the port's parameter name: numpy leaf}. The ``layers`` and
    ``encoder`` stacks are unstacked where their leaves are stacked on
    axis 0 (hybrid's ``layers`` always are); ``shared_attn`` and
    ``vision_proj`` pass as they are."""
    tree = dict(tree)
    for name, n in (("layers", cfg.num_layers),
                    ("encoder", cfg.encoder_layers)):
        if isinstance(tree.get(name), dict):
            tree[name] = [_unstack(tree[name], i) for i in range(n)]
        elif name in tree:
            tree[name] = list(tree[name])
    return dict(_flatten(tree))


def lm_params_from_numpy(tree: Dict[str, Any], cfg, *,
                         device="cuda") -> L.Params:
    """The reference's ``init_params`` tree as the port's parameters.

    Takes either layer layout: ``layers`` as one dict whose leaves are
    stacked on axis 0 (``scan_layers=True``) or as a list of per-layer
    dicts (``scan_layers=False``). Every leaf keeps its dtype (the MoE
    router stays float32 under bfloat16); a name, shape or dtype that
    does not match the port's layout for ``cfg`` raises ValueError.
    """
    dev = resolve_device(device)
    params = M.empty_params(cfg, device=dev)
    flat = _named_leaves(tree, cfg)
    want = dict(params.named_parameters())
    if set(flat) != set(want):
        raise ValueError(
            f"parameter names differ from the port's layout for {cfg.name}:"
            f" missing {sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    for name, p in want.items():
        t = _leaf(flat[name], dev)
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(
                f"{name}: got {tuple(t.shape)} {t.dtype}, the port's layout "
                f"has {tuple(p.shape)} {p.dtype}")
        p.data = t
    return params


def train_state_from_numpy(params_tree: Dict[str, Any], opt_tree, cfg, *,
                           device="cuda"):
    """The reference's ``TrainState`` (its ``params`` tree and its
    ``OptState(step, mu, nu)``, leaves as numpy, either layer layout) as
    the port's ``train_step.TrainState``: parameters with gradients on,
    float32 moments by parameter name, the step as a host int."""
    dev = resolve_device(device)
    params = lm_params_from_numpy(params_tree, cfg,
                                  device=dev).requires_grad_()
    shapes = {k: p.shape for k, p in params.named_parameters()}

    def moments(tree):
        out = {k: _leaf(v, dev) for k, v in _named_leaves(tree, cfg).items()}
        bad = sorted(set(out) ^ set(shapes)) or [
            k for k in shapes
            if out[k].shape != shapes[k] or out[k].dtype != torch.float32]
        if bad:
            raise ValueError(f"moments differ from the parameters' names, "
                             f"shapes or float32 at {bad[:5]}")
        return {k: out[k] for k in shapes}

    opt = OptState(step=int(np.asarray(opt_tree.step)),
                   mu=moments(opt_tree.mu), nu=moments(opt_tree.nu))
    return TrainState(params=params, opt=opt)


def decode_cache_from_numpy(cache, *, device="cuda") -> M.DecodeCache:
    """The reference's ``DecodeCache`` as the port's: every field (``kv``
    as KV or MLA, ``ssm`` as ``SSMState(h, conv)``, ``shared_kv`` and
    ``cross_kv`` as KV, ``enc_out``; None stays None), each leaf keeping
    its dtype; the index becomes a host integer."""
    dev = resolve_device(device)

    def fields(x, kind):
        return None if x is None else kind(*(_leaf(a, dev) for a in x))

    kv = None if cache.kv is None else fields(
        cache.kv, {"KVCache": L.KVCache,
                   "MLACache": L.MLACache}[type(cache.kv).__name__])
    return M.DecodeCache(
        kv=kv, ssm=fields(cache.ssm, L.SSMState),
        shared_kv=fields(cache.shared_kv, L.KVCache),
        enc_out=None if cache.enc_out is None else _leaf(cache.enc_out, dev),
        cross_kv=fields(cache.cross_kv, L.KVCache),
        index=int(np.asarray(cache.index)))


def to_numpy(x):
    """Tensors -> numpy arrays, through NamedTuples, dataclasses, lists,
    tuples and dicts (NamedTuples keep their type; other leaves pass)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if hasattr(x, "stacked"):  # pipeline.StackedRecords
        return to_numpy(x.stacked)
    return x
