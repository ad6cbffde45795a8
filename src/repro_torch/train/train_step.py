"""Train step factories (the port of the reference's
``train/train_step.py``).

``make_train_step(cfg, opt_cfg)`` returns ``(TrainState, batch) ->
(TrainState, metrics)``: autograd of ``loss + MOE_AUX_WEIGHT * aux``,
then ``optimizer.adamw_update`` in place. The reference's mesh (sharding
constraints on the logits) is not ported: ``mesh`` must be None.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, init_opt_state)

MOE_AUX_WEIGHT = 0.01


class TrainState(NamedTuple):
    params: L.Params      # parameters that require grad
    opt: OptState


def check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (a mesh) is not ported; the port trains on "
            "one device (ROADMAP Queue 1, item 8)")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in float32 (or wider). logits (B,S,V), labels
    (B,S) int; with ``mask`` (B,S) the masked mean, its count floored at
    one."""
    logits = L.wide(logits)
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - true_logit
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def make_loss_fn(cfg: ArchConfig, mesh=None):
    check_mesh(mesh)

    def loss_fn(params, batch):
        logits, aux, _ = M.forward(params, batch, cfg)
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
        total = loss + MOE_AUX_WEIGHT * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, mesh=None):
    loss_fn = make_loss_fn(cfg, mesh)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        named = dict(state.params.named_parameters())
        total, metrics = loss_fn(state.params, batch)
        grads = torch.autograd.grad(total, list(named.values()))
        grads = dict(zip(named, grads))
        _, new_opt, opt_metrics = adamw_update(grads, state.opt, named,
                                               opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, **opt_metrics, step=new_opt.step)
        return TrainState(params=state.params, opt=new_opt), metrics

    return train_step


def init_train_state(cfg: ArchConfig, *, seed: int = 0,
                     device="cuda") -> TrainState:
    """``model.init_params`` (drawn from ``seed`` on ``device``) with
    gradients on, and zero moments."""
    params = M.init_params(cfg, seed=seed, device=device).requires_grad_()
    return TrainState(params=params, opt=init_opt_state(params))
