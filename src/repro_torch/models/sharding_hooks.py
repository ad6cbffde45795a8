"""Activation sharding hooks and execution flags.

Model code stays placement-agnostic: the reference's step factories
install shardings here by name (e.g. the sequence-parallel residual
stream). The port runs on one card, so ``constrain`` is the identity
while no hook is set for that name, and raises when one is: multi-card
placement is not ported (ROADMAP Queue 1, multi-GPU placement). The
same table carries non-sharding execution flags read by ``get_flag``
(``attn_impl``: sdpa | flash | auto; ``causal_skip``).

The table is process-global, as in the reference: a caller that sets
hooks resets them (``set_hooks({})``) when done.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

_HOOKS: Dict[str, object] = {}


def set_hooks(hooks: Optional[Dict[str, object]]) -> None:
    global _HOOKS
    _HOOKS = dict(hooks or {})


def get_hooks() -> Dict[str, object]:
    return dict(_HOOKS)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    if _HOOKS.get(name) is None:
        return x
    raise NotImplementedError(
        f"sharding hook {name!r} is set, but multi-card placement is not "
        "ported (ROADMAP Queue 1, multi-GPU placement); the port runs on "
        "one device")


def get_flag(name: str, default):
    """Non-sharding execution flags (e.g. attn_impl: sdpa|flash|auto)."""
    return _HOOKS.get(name, default)
