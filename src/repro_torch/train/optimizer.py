"""AdamW + LR schedule over named tensors (the port of the reference's
``train/optimizer.py``).

Parameters, gradients and moments are dicts keyed by the model's
``named_parameters()`` names. Moments are float32 whatever the
parameters' dtype. The update follows the reference op for op (clip
scale, bias corrections from ``step + 1``, weight decay on every leaf,
the parameter recast to its dtype); it is not ``torch.optim.AdamW``,
whose decoupled decay and eps placement round differently.

The step count is a host integer and the schedule's scalars are computed
on the host in float32 (numpy), as the reference's traced float32
scalars are, so an update needs no device sync. On the card (plain or
DTensor leaves) the update runs in the multi-tensor kernel
(``kernels/adamw.py``), in place, with
no transient beyond a double a chunk; elsewhere (``adamw_update_eager``)
it runs leaf by leaf and in place, so the float32 transients of one leaf
at a time are alive on top of the state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import adamw as KA


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: int                         # updates taken
    mu: Dict[str, torch.Tensor]       # float32 first moments, by name
    nu: Dict[str, torch.Tensor]       # float32 second moments, by name


def lr_schedule(cfg: OptimizerConfig, step: int) -> float:
    """Linear warm-up to ``peak_lr``, then a cosine to ``min_lr_ratio`` x
    ``peak_lr`` at ``total_steps``; float32 arithmetic, as the reference."""
    f32 = np.float32
    s = f32(step)
    if s < cfg.warmup_steps:
        return float(f32(cfg.peak_lr) * s / f32(max(cfg.warmup_steps, 1)))
    progress = np.clip((s - f32(cfg.warmup_steps))
                       / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       f32(0), f32(1))
    cos = f32(cfg.min_lr_ratio) + f32((1 - cfg.min_lr_ratio) * 0.5) \
        * (f32(1) + np.cos(f32(math.pi) * progress))
    return float(f32(cfg.peak_lr) * cos)


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero float32 moments shaped as ``params`` (a dict of named tensors,
    or a module, whose ``named_parameters()`` are taken); a DTensor
    parameter's moments are DTensors of its placements."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return OptState(
        step=0,
        mu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    DTensor leaves give the global norm, as a plain tensor equal on every
    rank."""
    total = 0
    for g in tree.values():
        total = total + torch.sum(torch.square(g.float()))
    norm = torch.sqrt(total)
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


def _step_scalars(cfg: OptimizerConfig, step: int) -> Tuple[float, float,
                                                             float]:
    """(learning rate, 1 - b1^step, 1 - b2^step) of update ``step``, in
    float32 as the reference computes them."""
    f32 = np.float32
    return (lr_schedule(cfg, step),
            float(f32(1) - f32(cfg.b1) ** f32(step)),
            float(f32(1) - f32(cfg.b2) ** f32(step)))


def _clip_scale(cfg: OptimizerConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt: OptState,
                 params: Mapping[str, torch.Tensor], cfg: OptimizerConfig
                 ) -> Tuple[Mapping[str, torch.Tensor], OptState, dict]:
    """One AdamW step. Updates ``params`` and ``opt``'s moments in place
    and returns (params, the advanced OptState, metrics): ``grad_norm``
    (a device scalar, before clipping) and ``lr`` (a float). DTensor
    gradients must have their parameters' placements.

    ``kernels/adamw.route`` decides who computes it: plain CUDA leaves on
    one device take the multi-tensor kernel (three launches, the eager
    loop's arithmetic; the norm summed in a fixed order in double); DTensor
    leaves on CUDA its update on their local tensors, with the eager
    path's norm and clip scale (``global_norm`` sums over the mesh), so
    they get the eager loop's bits; CPU, fake and meta tensors
    ``adamw_update_eager``; any other CUDA case raises ``ValueError``."""
    way = KA.route(grads, params, opt.mu, opt.nu)
    if way == "eager":
        return adamw_update_eager(grads, opt, params, cfg)
    step = opt.step + 1
    lr, b1c, b2c = _step_scalars(cfg, step)
    norm_scale = None
    if way == "mesh":
        gnorm = global_norm(grads)
        norm_scale = torch.stack([gnorm, _clip_scale(cfg, gnorm)])
    gnorm = KA.adamw(grads, params, opt.mu, opt.nu,
                     KA.scalars(cfg, lr, b1c, b2c), norm_scale)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, mu=opt.mu, nu=opt.nu), metrics


@torch.no_grad()
def adamw_update_eager(grads: Mapping[str, torch.Tensor], opt: OptState,
                       params: Mapping[str, torch.Tensor],
                       cfg: OptimizerConfig
                       ) -> Tuple[Mapping[str, torch.Tensor], OptState, dict]:
    """``adamw_update`` leaf by leaf in eager PyTorch (the plain version):
    the CPU's and fake tensors' path, and the kernel's yardstick."""
    step = opt.step + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    lr, b1c, b2c = _step_scalars(cfg, step)
    # Elementwise from here: a DTensor's parameter, gradient and moments
    # share placements, so each rank updates its own shards.
    for name, p in params.items():
        m, v, p = KA.local(opt.mu[name]), KA.local(opt.nu[name]), KA.local(p)
        g = KA.local(grads[name]).float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        mh = m / b1c
        vh = v / b2c
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        del mh, vh
        p.copy_((pf - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, mu=opt.mu, nu=opt.nu), metrics
