"""Synthetic token data pipeline (the port of the reference's
``train/data.py``).

Deterministic and seekable (the state is the step index), so a restart
from a checkpoint resumes the exact stream.

The stream is a noisy affine recurrence t_{i+1} = (a * t_i + c) mod V with
p_noise random replacements: learnable structure (the loss drops quickly)
but not degenerate. The draws come from a CPU ``torch.Generator`` seeded
with (seed, step), so a batch is the same whichever device it is moved
to; they are not the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    seed: int = 0
    p_noise: float = 0.1
    mult: int = 31
    add: int = 7


def batch_at(cfg: DataConfig, step: int, *,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Batch for a given global step (a pure function of (cfg, step)):
    ``tokens`` and next-token ``labels``, (B, S) int64 on ``device``."""
    gen = torch.Generator().manual_seed((cfg.seed << 32) + step)
    shape = (cfg.batch_size, cfg.seq_len + 1)
    t = torch.randint(0, cfg.vocab_size, (cfg.batch_size,), generator=gen)
    seq = [t]
    for _ in range(cfg.seq_len):
        t = (t * cfg.mult + cfg.add) % cfg.vocab_size
        seq.append(t)
    tokens = torch.stack(seq, dim=1)                       # (B, S+1)
    noise = torch.rand(shape, generator=gen) < cfg.p_noise
    rand = torch.randint(0, cfg.vocab_size, shape, generator=gen)
    tokens = torch.where(noise, rand, tokens).to(resolve_device(device))
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def stream(cfg: DataConfig, start_step: int = 0, *,
           device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, device=device)
        step += 1
