"""Train step factories (the port of the reference's
``train/train_step.py``).

``make_train_step(cfg, opt_cfg, mesh)`` returns ``(TrainState, batch) ->
(TrainState, metrics)``: autograd of ``loss + MOE_AUX_WEIGHT * aux``,
then ``optimizer.adamw_update`` in place.

With a ``mesh`` (a ``DeviceMesh`` with "data" and "model" axes, and
"pod" on a multi-pod mesh) the parameters and moments are DTensors
placed by ``distributed.sharding.param_shardings`` and the batch by
``batch_shardings``; DTensor's propagation inserts the collectives, as
GSPMD's does for the reference. The logits are redistributed to batch
over the data axes and vocab over "model" (when it divides the vocab),
as the reference's sharding constraint does, so the cross-entropy runs
vocab-sharded. Each gradient is redistributed to its parameter's
placements (FSDP's reduce-scatter) before the update. Metrics come back
as plain tensors, equal on every rank.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as S
from repro_torch.models import layers as L
from repro_torch.models import model as M
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in float32 (or wider). logits (B,S,V), labels
    (B,S) int; with ``mask`` (B,S) the masked mean, its count floored at
    one. The true logit's trailing dim is dropped after the subtraction:
    on vocab-sharded logits the gather's result is a masked partial sum
    whose mask has the gather's shape, so it is reduced before the
    select changes that shape."""
    logits = L.wide(logits)
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())
    nll = (lse[..., None] - true_logit)[..., 0]
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
        if logits_sharding is not None:
            logits = S.place(logits, logits_sharding)
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
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
