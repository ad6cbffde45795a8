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
through (an op with no sharding strategy) on each rank's local tensors;
``run_local`` does so with placements the caller chooses, and
``einsum`` runs a product of two DTensors as a plain einsum of each
rank's shards. Together they keep DTensor off every view that merges a
sharded dim with another: ``torch.einsum`` lowers to a ``bmm`` of
flattened operands, and DTensor cannot flatten a dim that is sharded
unless it leads the group (torch 2.11 refuses the view; 2.13 makes a
strided shard whose ``bmm`` propagation fails on fake tensors).

The table is process-global, as in the reference: a caller that sets
hooks resets them (``set_hooks({})``) when done.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_HOOKS: Dict[str, object] = {}

# Mesh axes that split the batch (``distributed.sharding.batch_axes``).
BATCH_AXES = ("pod", "data")


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


def batch_placements(mesh, batch: int):
    """Placements of a tensor whose dim 0 is a batch of ``batch`` rows:
    split over the batch axes of ``mesh`` in order, each while the rows
    still divide evenly, replicated on the other axes."""
    out, ways = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(i)
        split = name in BATCH_AXES and batch % (ways * size) == 0
        ways *= size if split else 1
        out.append(Shard(0) if split else Replicate())
    return tuple(out)


def run_local(fn, mesh, args: Sequence, placements: Sequence,
              out_placements, out_shape, grad_placements=None):
    """``fn(*local args)`` on each rank, as one DTensor op: each argument
    (a DTensor, or a plain tensor taken as replicated) is redistributed
    to its entry of ``placements`` and passed as its local shard; the
    result (one tensor) is a DTensor of ``out_placements`` and global
    ``out_shape``. ``grad_placements`` gives each argument's gradient
    placements where they differ from its own: ``Partial()`` on a mesh
    axis where the argument is replicated but the ranks computed with
    different parts of the others (each rank's gradient is then one
    term of the sum)."""
    local = []
    for i, (t, pl) in enumerate(zip(args, placements)):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        grad = grad_placements[i] if grad_placements else None
        local.append(t.redistribute(mesh, tuple(pl)).to_local(
            grad_placements=grad))
    out = fn(*local)
    stride, acc = [], 1
    for n in reversed(out_shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(out, mesh, tuple(out_placements),
                              run_check=False, shape=torch.Size(out_shape),
                              stride=tuple(stride))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of two operands; on DTensors, a plain
    einsum of each rank's shards (``run_local``). For each mesh axis one
    index (or none) is sharded: the one an operand shards there; where
    the two shard different indices, or only the smaller shards one that
    the larger has, the smaller operand is gathered on that axis (as FSDP
    gathers a weight). The other operand is sharded on that index too
    where it has it (a local slice) and replicated where it does not;
    the result is sharded on it where the output keeps it, and a
    ``Partial`` sum where it is contracted. A ``Partial`` operand is
    reduced first."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    sizes = dict(zip(ia, a.shape))
    sizes.update(zip(ib, b.shape))

    def index(t, subs, axis):
        pl = t.placements[axis] if isinstance(t, DTensor) else Replicate()
        return subs[pl.dim] if isinstance(pl, Shard) else None

    small_a = a.numel() <= b.numel()
    pa, pb, po, ga, gb = [], [], [], [], []
    for axis in range(mesh.ndim):
        la, lb = index(a, ia, axis), index(b, ib, axis)
        if la is not None and lb is not None and la != lb:
            la, lb = (None, lb) if small_a else (la, None)
        # Only the smaller one is split, on an index the larger has: gather
        # the smaller, not re-slice the larger (which may be split on that
        # dim over another axis already, as a decode step's cache is).
        elif la is not None and lb is None and la in ib and small_a:
            la = None
        elif lb is not None and la is None and lb in ia and not small_a:
            lb = None
        idx = la if la is not None else lb
        for subs, p, g in ((ia, pa, ga), (ib, pb, gb)):
            if idx is not None and idx in subs:
                p.append(Shard(subs.index(idx)))
                g.append(Shard(subs.index(idx)))
            else:
                p.append(Replicate())
                g.append(Replicate() if idx is None else Partial())
        po.append(Replicate() if idx is None else
                  Shard(out.index(idx)) if idx in out else Partial())
    return run_local(lambda x, y: torch.einsum(eq, x, y), mesh, (a, b),
                     (pa, pb), po, [sizes[c] for c in out], (ga, gb))
