"""Train step factories (the port of the reference's
``train/train_step.py``).

``make_train_step(cfg, opt_cfg, mesh)`` returns ``(TrainState, batch) ->
(TrainState, metrics)``: autograd of ``loss + MOE_AUX_WEIGHT * aux``,
then ``optimizer.adamw_update`` in place, under the span
``repro.train/optimizer``.

With a ``mesh`` (a ``DeviceMesh`` with "data" and "model" axes, and
"pod" on a multi-pod mesh) the parameters and moments are DTensors
placed by ``distributed.sharding.param_shardings`` and the batch by
``batch_shardings``; DTensor's propagation inserts the collectives, as
GSPMD's does for the reference. The logits are redistributed to batch
over the data axes and vocab over "model" (when it divides the vocab),
as the reference's sharding constraint does, and the cross-entropy runs
on each rank's shard (``cross_entropy(..., sharding=)``): where "model"
splits the vocab, each rank reduces its slice's max, sum of exp and true
logit and all-reduces them over "model" (a vocab-parallel loss), and its
backward is local, so no rank holds the logits' gradient at its global
(B, S, V) shape, as the reference's partitioner keeps the cotangent in
the logits' sharding. Each gradient is redistributed to its parameter's
placements (FSDP's reduce-scatter) before the update. Metrics come back
as plain tensors, equal on every rank.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as S
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding_hooks as hooks
from repro_torch.obs.trace import annotate
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, init_opt_state)

MOE_AUX_WEIGHT = 0.01


class TrainState(NamedTuple):
    params: L.Params      # parameters that require grad
    opt: OptState


def _validate_mesh(mesh) -> None:
    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if not {"data", "model"} <= set(mesh.mesh_dim_names or ()):
        raise ValueError(f"a train mesh needs 'data' and 'model' axes, got "
                         f"{mesh.mesh_dim_names}")


def on_mesh(mesh):
    """The context the model runs in on ``mesh``: tensors the model makes
    itself (positions, masks, the aux loss's zero) hold the same value on
    every rank, so DTensor takes them as replicated, as GSPMD takes an
    unannotated constant. Nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return implicit_replication()


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, S) next-token NLL in float32 (or wider)."""
    logits = L.wide(logits)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    if group is None:
        return x
    out = funcol.all_reduce(x, op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def _wide_copy(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32), copy=True)


class _ShardNLL(torch.autograd.Function):
    """One rank's rows of the NLL from its local logits ``x`` (b, S, v):
    the vocab's slice starting at ``offset``, its terms all-reduced over
    ``group`` (the vocab axis; None where ``x`` holds the whole vocab).
    The slice's max, sum of ``exp(x - max)`` and true logit (where the
    label falls in the slice, else 0) are reduced; the backward is local,
    ``softmax(x) - onehot`` times the incoming gradient. Each pass holds
    one float32 copy of ``x`` at a time (exp in place)."""

    @staticmethod
    def forward(ctx, x, labels, group, offset):
        idx = labels.long() - offset
        inside = (idx >= 0) & (idx < x.shape[-1])
        idx = idx.clamp(0, x.shape[-1] - 1)
        e = _wide_copy(x)
        true = torch.gather(e, -1, idx[..., None])[..., 0]
        true = _all_reduce(torch.where(inside, true, torch.zeros_like(true)),
                           "sum", group)
        m = _all_reduce(e.amax(-1), "max", group)
        s = _all_reduce(e.sub_(m[..., None]).exp_().sum(-1), "sum", group)
        del e
        lse = torch.log(s) + m
        ctx.save_for_backward(x, lse, idx, inside)
        return lse - true

    @staticmethod
    def backward(ctx, grad):
        x, lse, idx, inside = ctx.saved_tensors
        g = _wide_copy(x).sub_(lse[..., None]).exp_()
        g.scatter_add_(-1, idx[..., None], -inside[..., None].to(g.dtype))
        return g.mul_(grad[..., None]).to(x.dtype), None, None, None


def _nll_on_mesh(logits: torch.Tensor, labels: torch.Tensor,
                 sharding: S.Sharding) -> torch.Tensor:
    """``_nll`` of logits placed by ``sharding`` (batch over the batch
    axes, vocab over "model" where it divides), each rank on its own
    shard through ``_ShardNLL`` (``run_local``): the result is split like
    the batch, and the logits' gradient keeps their placement. Where
    nothing is split, the DTensor runs ``_nll`` itself (every shard is
    the whole tensor, and the arithmetic stays the one-device one)."""
    mesh, placements = sharding
    if not any(isinstance(p, Shard) for p in placements):
        return _nll(S.place(logits, sharding), labels)
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in placements)
    group, offset = None, 0
    vocab = [i for i, p in enumerate(placements)
             if isinstance(p, Shard) and p.dim == 2]
    if vocab:
        (axis,) = vocab
        group = (mesh, axis)
        offset = mesh.get_local_rank(axis) * (logits.shape[-1]
                                              // mesh.size(axis))
    return hooks.run_local(
        lambda x, y: _ShardNLL.apply(x, y, group, offset), mesh,
        (logits, labels), (placements, rows), rows, tuple(logits.shape[:2]))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  sharding: Optional[S.Sharding] = None) -> torch.Tensor:
    """Mean next-token CE in float32 (or wider). logits (B,S,V), labels
    (B,S) int; with ``mask`` (B,S) the masked mean, its count floored at
    one. With ``sharding`` (the logits' placement on a mesh) each rank
    computes its own shard's terms (``_nll_on_mesh``), so the logits'
    gradient keeps that placement."""
    nll = _nll(logits, labels) if sharding is None \
        else _nll_on_mesh(logits, labels, sharding)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def make_loss_fn(cfg: ArchConfig, mesh=None):
    _validate_mesh(mesh)
    logits_sharding = None
    if mesh is not None:
        vocab = "model" if cfg.vocab_size % S.axis_sizes(mesh)["model"] == 0 \
            else None
        logits_sharding = S.Sharding(mesh, S.to_placements(
            S.P(S.batch_axes(mesh), None, vocab), mesh))

    def loss_fn(params, batch):
        logits, aux, _ = M.forward(params, batch, cfg)
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"),
                             logits_sharding)
        total = loss + MOE_AUX_WEIGHT * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, mesh=None):
    loss_fn = make_loss_fn(cfg, mesh)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        named = dict(state.params.named_parameters())
        with on_mesh(mesh):
            total, metrics = loss_fn(state.params, batch)
            grads = torch.autograd.grad(total, list(named.values()))
        grads = {k: S.place(g, S.Sharding(p.device_mesh, p.placements))
                 if isinstance(p, DTensor) else g
                 for (k, p), g in zip(named.items(), grads)}
        with annotate("repro.train/optimizer"):
            _, new_opt, opt_metrics = adamw_update(grads, state.opt, named,
                                                   opt_cfg)
        metrics = {k: _full(v.detach()) for k, v in metrics.items()}
        metrics = dict(metrics, **opt_metrics, step=new_opt.step)
        return TrainState(params=state.params, opt=new_opt), metrics

    return train_step


def init_train_state(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                     mesh=None) -> TrainState:
    """``model.init_params`` (drawn from ``seed`` on ``device``) with
    gradients on, and zero moments. With ``mesh`` the parameters are
    placed by ``param_shardings`` leaf by leaf (each source freed before
    the next) and the moments made on the mesh with their placements."""
    params = M.init_params(cfg, seed=seed, device=device).requires_grad_()
    if mesh is not None:
        params = S.distribute(params, S.param_shardings(params, mesh))
    return TrainState(params=params, opt=init_opt_state(params))
