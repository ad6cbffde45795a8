"""Plain AdamW, the reference's optimizer for training cells.

The rule the port's optimizer states: the global gradient norm over
every leaf, each gradient scaled by ``min(1, clip_norm / (norm +
1e-9))``; moments ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2)
g^2``; bias corrections from the step count (the first step is 1);
``p -= lr (m_hat / (sqrt(v_hat) + eps) + weight_decay p)`` on every
leaf; the learning rate rises linearly over ``warmup_steps`` and then
follows a cosine down to ``min_lr_ratio`` of its peak at
``total_steps``. Every number in float32, the schedule in float64.
``opt`` holds the nine settings by their names (``peak_lr``,
``warmup_steps``, ``total_steps``, ``min_lr_ratio``, ``b1``, ``b2``,
``eps``, ``weight_decay``, ``clip_norm``); none has a default here.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of update ``step`` (1 for the first)."""
    warm, total = opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return opt["peak_lr"] * step / max(warm, 1)
    progress = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    ratio = opt["min_lr_ratio"]
    return opt["peak_lr"] * (ratio + (1 - ratio) * 0.5
                             * (1 + math.cos(math.pi * progress)))


@torch.no_grad()
def update(weights: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor],
           step: int, opt: dict) -> Tuple[float, float]:
    """Update ``step`` (1 for the first), in place on float32 ``weights``,
    ``m`` and ``v``; returns (the gradient norm before clipping, the clip
    scale)."""
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                         for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / (norm + 1e-9))
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for name, p in weights.items():
        g = grads[name] * scale
        m[name].mul_(b1).add_((1 - b1) * g)
        v[name].mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = (m[name] / c1) / (torch.sqrt(v[name] / c2) + opt["eps"])
        p.sub_(lr * (delta + opt["weight_decay"] * p))
    return norm, scale
