"""Sharding rules: parameter / optimizer / cache / input placements (the
port of the reference's ``distributed/sharding.py``).

Strategy, as the reference's: 2-D sharded weights — the contraction or
feature dim over "model" (TP), the other large dim over "data"
(FSDP/ZeRO-3); experts over "model" (EP); batch over ("pod", "data");
KV caches shard batch over "data" and heads over "model" when divisible,
falling back to sequence sharding for batch-1 long-context decode.

Two layers:
  - the rules are a pure function of names, shapes and the mesh's axis
    sizes (``param_specs``, ``batch_specs``, ``cache_specs``): each
    returns a ``PartitionSpec`` per leaf, one entry per tensor dim (None,
    an axis name, or a tuple of names sharding that dim major to minor).
    ``mesh`` there is a ``DeviceMesh`` or a mapping {axis name: size},
    so the rules need no process group;
  - the edge (``param_shardings``, ``batch_shardings``,
    ``cache_shardings``, ``replicated``) turns each spec into a
    ``Sharding(mesh, placements)`` over a ``DeviceMesh`` (one placement
    per mesh dim: ``Shard(d)`` or ``Replicate()``), and ``distribute``
    places a tree by them, leaf by leaf.

The leaf's name is the last non-integer key of its path: a parameter
``layers.3.attn.wq`` is named ``wq``, its layer index is an integer key.
The port's layers are a list, so a layer's leaf has the rule's rank; the
reference's stacked leaves carry a leading layer dim, which the rules
give a leading None (so the port's spec for layer i is the reference's
stacked spec with its leading entry dropped). A ``moe`` key turns the
expert rules on, a ``shared`` key (the shared expert, a plain MLP) off.
Every axis is checked against the dim's size: a dim that the axis does
not divide is replicated (the reference's ``_axis_ok``), never sharded
unevenly.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

# name -> spec template over the unstacked rank. "F" = fsdp axis ("data"),
# "M" = tensor axis ("model"), None = replicate.
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("M", "F"),
    "lm_head": ("F", "M"),
    "vision_proj": ("F", "M"),
    # attention (GQA + shared/cross variants share names)
    "wq": ("F", "M", None),
    "wk": ("F", "M", None),
    "wv": ("F", "M", None),
    "wo": ("M", None, "F"),
    # MLA
    "w_dq": ("F", None),
    "w_uq": (None, "M", None),
    "w_dkv": ("F", None),
    "w_kr": ("F", None),
    "w_uk": (None, "M", None),
    "w_uv": (None, "M", None),
    # dense MLP (rank 2) / MoE experts (rank 3, leading E) disambiguated
    # by rank in _spec_for.
    "w_in": ("F", "M"),
    "w_gate": ("F", "M"),
    "w_out": ("M", "F"),
    "router": ("F", None),
    # mamba
    "conv_w": ("M", None),
    "conv_b": ("M",),
    "a_log": (None,),
    "d_skip": (None,),
    "dt_bias": (None,),
    "out_norm": (None,),
    # norms / scalars
    "ln1": (None,), "ln2": (None,), "ln_x": (None,),
    "final_norm": (None,), "enc_final_norm": (None,),
    "q_norm": (None,), "kv_norm": (None,),
    "step": (),
}

_MOE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # experts over "model" (EP), d/f over "data" (FSDP)
    "w_in": ("M", "F", None),
    "w_gate": ("M", "F", None),
    "w_out": ("M", "F", None),
}

Axis = Optional[Any]          # None, an axis name, or a tuple of names


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of axis names that shard the dim together, major first."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Sharding(NamedTuple):
    """A placement on a ``DeviceMesh`` (the port's ``NamedSharding``):
    one ``Shard(d)`` or ``Replicate()`` per mesh dim."""

    mesh: Any
    placements: Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axis(mesh) -> Any:
    return "data"


def batch_axes(mesh) -> Any:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else "data"


def _axis_ok(sizes: Mapping[str, int], axis: Optional[str],
             dim: int) -> Optional[str]:
    if axis is None:
        return None
    name = {"F": "data", "M": "model"}[axis]
    return name if dim % sizes[name] == 0 else None


def _spec_for(keys, shape, sizes: Mapping[str, int]) -> PartitionSpec:
    """The spec of the leaf at key path ``keys`` (strings and ints) with
    ``shape``."""
    name = None
    in_moe = False
    for key in keys:
        if key == "moe":
            in_moe = True
        if key == "shared":
            in_moe = False  # shared expert is a plain MLP
        if key is not None and not isinstance(key, int):
            name = key
    if name not in _PARAM_RULES and name not in _MOE_RULES:
        raise KeyError(f"no sharding rule for param {name!r} "
                       f"(path {'/'.join(map(str, keys))})")
    ndim = len(shape)
    rule = _PARAM_RULES.get(name, ())
    if in_moe and name in _MOE_RULES and ndim >= 3:
        rule = _MOE_RULES[name]
    if ndim == len(rule) + 1:        # stacked layer/group leading dim
        rule = (None,) + rule
    elif ndim == len(rule) + 2:      # zamba grouped stacking (G, k, ...)
        rule = (None, None) + rule
    elif ndim != len(rule):
        raise ValueError(f"rank mismatch for {name}: rule {rule}, "
                         f"shape {tuple(shape)}")
    return P(*(_axis_ok(sizes, a, shape[i]) for i, a in enumerate(rule)))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _keys(name: str):
    """A dotted parameter name as path keys, layer indices as ints."""
    return [int(k) if k.isdigit() else k for k in name.split(".")]


def _is_leaf(tree) -> bool:
    return tree is None or isinstance(tree, (PartitionSpec, Sharding,
                                             torch.Tensor))


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """(key path, leaf) of NamedTuples, dicts, lists and modules (their
    named parameters); specs, shardings and other values are leaves."""
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + tuple(_keys(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield path + tuple(_keys(name)), p
    else:
        yield path, tree


def _map(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; a module
    becomes a dict {parameter name: fn(...)}, ``None`` stays None."""
    if _is_leaf(tree):
        return None if tree is None else fn(path, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + tuple(_keys(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, nn.Module):
        return {name: fn(path + tuple(_keys(name)), p)
                for name, p in tree.named_parameters()}
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def param_specs(tree, mesh):
    """A spec per leaf of a parameter or train-state tree (a
    ``TrainState``, a parameter module or a dict of named tensors);
    modules become dicts keyed by parameter name."""
    sizes = axis_sizes(mesh)
    return _map(lambda path, leaf: _spec_for(path, _shape(leaf), sizes),
                tree)


def batch_specs(batch_tree, mesh):
    """tokens/labels (B, S) and stub embeddings (B, T, D): batch over the
    data axes when divisible, replicate otherwise (batch-1 decode)."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes(sizes)
    dsize = int(np.prod([sizes[a] for a in
                         (baxes if isinstance(baxes, tuple) else (baxes,))]))

    def spec(path, leaf):
        shape = _shape(leaf)
        lead = baxes if shape[0] % dsize == 0 else None
        return P(lead, *([None] * (len(shape) - 1)))

    return _map(spec, batch_tree)


def cache_specs(cache_tree, mesh):
    """KV caches: (L, B, G, S, K) — batch over "data" when divisible, else
    the SEQUENCE axis is sharded over "data" (flash-decoding layout for
    long context). Heads over "model" when divisible. MLA latent caches:
    batch over "data", latent replicated. A host-int cache index is
    replicated."""
    sizes = axis_sizes(mesh)
    data, model = sizes["data"], sizes["model"]

    def spec(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 5:    # (L, B, G, S, K) kv cache
            if shape[1] % data == 0:
                return P(None, "data",
                         "model" if shape[2] % model == 0 else None,
                         None, None)
            return P(None, None, "model" if shape[2] % model == 0 else None,
                     "data" if shape[3] % data == 0 else None, None)
        if nd == 4:    # (L, B, S, C) MLA latent / (L, B, conv_dim, W)
            if shape[1] % data == 0:
                return P(None, "data", None, None)
            # batch-1 long context: shard MLA seq axis over data
            return P(None, None, "data" if shape[2] % data == 0 else None,
                     None)
        if nd == 3:    # (B, enc_seq, D) encoder output
            return P("data" if shape[0] % data == 0 else None, None, None)
        return P(*([None] * nd))

    return _map(spec, cache_tree)


# ---------------------------------------------------------------------------
# specs <-> DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec, mesh) -> Tuple[Any, ...]:
    """A spec as DTensor placements over ``mesh`` (a ``DeviceMesh`` or an
    ordered mapping {axis name: size}), one per mesh dim. DTensor shards
    a tensor dim over several mesh dims in mesh order (the first is the
    major one), so a tuple entry must list its axes in the mesh's order.
    An axis of size 1 holds the whole dim: it is placed ``Replicate()``,
    the same data, which DTensor can reshape freely (torch 2.11 refuses
    to flatten a dim sharded even over a size-1 axis)."""
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec entry {entry} shards dim {d} in another "
                             f"order than the mesh's axes {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh axis {names[i]!r} is used twice in "
                                 f"{spec}")
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def to_spec(placements, mesh, ndim: int) -> PartitionSpec:
    """DTensor placements (``Shard``/``Replicate``) over ``mesh`` as a spec
    of ``ndim`` entries."""
    entries: list = [[] for _ in range(ndim)]
    for name, pl in zip(axis_sizes(mesh), placements):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} has no spec")
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


def _to_shardings(specs, mesh):
    return _map(lambda path, spec: Sharding(mesh, to_placements(spec, mesh)),
                specs)


def param_shardings(tree, mesh):
    """A ``Sharding`` per leaf of a parameter or train-state tree."""
    return _to_shardings(param_specs(tree, mesh), mesh)


def batch_shardings(batch_tree, mesh):
    return _to_shardings(batch_specs(batch_tree, mesh), mesh)


def cache_shardings(cache_tree, mesh):
    return _to_shardings(cache_specs(cache_tree, mesh), mesh)


def replicated(tree, mesh):
    return _map(lambda path, leaf: Sharding(
        mesh, (Replicate(),) * mesh.ndim), tree)


def place(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """One tensor as a DTensor placed by ``sharding``: a DTensor is
    redistributed, a plain tensor (the same full value on every rank) is
    split, and each rank keeps its shard."""
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def distribute(tree, shardings):
    """``tree`` placed by ``shardings`` (a congruent tree, as
    ``param_shardings`` gives), leaf by leaf: each tensor leaf is placed
    by ``place`` and its source dropped before the next, so no second
    copy of the whole tree is alive. A module's parameters are replaced
    by parameters that hold the DTensors (``requires_grad`` kept); host
    ints stay as they are. Returns the placed tree."""
    flat = dict(_leaves(shardings))
    return _place_tree(tree, (), flat)


def _place_tree(tree, path, flat):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_place_tree(getattr(tree, f), path + (f,), flat)
                            for f in tree._fields))
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = _place_tree(tree[k], path + tuple(_keys(k)), flat)
        return tree
    if isinstance(tree, nn.Module):
        for name in [n for n, _ in tree.named_parameters()]:
            owner, _, leaf = name.rpartition(".")
            module = tree.get_submodule(owner)
            grad = getattr(module, leaf).requires_grad
            placed = place(getattr(module, leaf).detach(),
                           flat[path + tuple(_keys(name))])
            setattr(module, leaf, nn.Parameter(placed, requires_grad=grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return place(tree, flat[path])
    return tree
