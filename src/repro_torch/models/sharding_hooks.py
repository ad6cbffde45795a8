"""Activation sharding hooks and execution flags.

Model code stays placement-agnostic: step factories install shardings
here by name (e.g. the sequence-parallel residual stream), each a
``distributed.sharding.Sharding(mesh, placements)``. ``constrain(x,
name)`` is the identity while no hook is set for that name; with one
set it redistributes the DTensor ``x`` to the hook's placements (the
port of ``with_sharding_constraint``), and refuses a plain tensor, which
has no placement to change. The same table carries non-sharding
execution flags read by ``get_flag`` (``attn_impl``: sdpa | flash |
auto; ``causal_skip``).

``on_local`` runs a piece of model code that DTensor cannot propagate
through (an op with no sharding strategy) on each rank's local tensors.

The table is process-global, as in the reference: a caller that sets
hooks resets them (``set_hooks({})``) when done.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_HOOKS: Dict[str, object] = {}


def set_hooks(hooks: Optional[Dict[str, object]]) -> None:
    global _HOOKS
    _HOOKS = dict(hooks or {})


def get_hooks() -> Dict[str, object]:
    return dict(_HOOKS)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    s = _HOOKS.get(name)
    if s is None:
        return x
    if not isinstance(x, DTensor):
        raise ValueError(f"sharding hook {name!r} is set, but its tensor is "
                         "not a DTensor (no placement to constrain)")
    return x.redistribute(s.mesh, s.placements)


def get_flag(name: str, default):
    """Non-sharding execution flags (e.g. attn_impl: sdpa|flash|auto)."""
    return _HOOKS.get(name, default)


def on_local(fn, *tensors, rows: bool = True):
    """``fn(*tensors)``, where ``fn`` holds ops that DTensor has no
    sharding strategy for (the MoE dispatch's sort, scatter and
    ``index_add_``). With plain tensors it is just the call. With
    DTensors, GSPMD's implicit choice is made explicit: every input is
    redistributed to one layout, each rank runs ``fn`` on its local
    tensors, and each output is a DTensor of that layout. The layout
    keeps the first input's batch (dim 0) sharding when ``rows`` (``fn``
    must then treat its rows independently) and replicates all else, so
    each rank computes exactly what one device computes for its rows.
    """
    lead = next((t for t in tensors if isinstance(t, DTensor)), None)
    if lead is None:
        return fn(*tensors)
    mesh = lead.device_mesh
    layout = tuple(Shard(0) if rows and isinstance(p, Shard) and p.dim == 0
                   else Replicate() for p in lead.placements)
    local = [t.redistribute(mesh, layout).to_local()
             if isinstance(t, DTensor) else t for t in tensors]
    out = fn(*local)

    def wrap(t):
        return DTensor.from_local(t, mesh, layout, run_check=False)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)
