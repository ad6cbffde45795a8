"""Pipeline parallelism over the "pod" axis (the port of the reference's
``distributed/pipeline.py``).

The multi-pod mesh's "pod" axis can act as data parallelism (default)
or as GPipe-style pipeline stages: the cross-pod fabric is the slowest,
and pipelining sends only (micro_batch, seq, d_model) activations across
it once per microbatch instead of all-reducing every gradient.

Mechanics, as the reference's ``shard_map`` + ``ppermute``:
  - stage s (its index along ``axis``) holds layers [s*L/P, (s+1)*L/P) of
    the layer-stacked params (L, ...);
  - microbatches stream round a ring of point-to-point sends
    (``dist.batch_isend_irecv`` over the axis's process group); stage s
    idles for s warm-up ticks (GPipe bubble = (P-1)/(M+P-1));
  - the last stage's outputs are all-gathered over the axis and
    selected, so every rank returns the full output.

Forward only (decode/prefill pipelining and serving). Every rank of the
mesh calls ``pipeline_apply``; ranks that differ only off ``axis`` run
the same pipeline on the same input.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


@torch.no_grad()
def pipeline_apply(layer_fn: Callable, params_stacked, x: torch.Tensor, *,
                   mesh, num_micro: int, axis: str = "pod") -> torch.Tensor:
    """Run ``layer_fn`` stacks as a pipeline over ``axis`` of ``mesh``.

    layer_fn(params_slice, x) -> x, applied layer by layer to the stage's
    share of the stack. x: (B, S, D), the whole input on every rank, B
    divisible by ``num_micro``. params_stacked: a tuple, list or dict of
    tensors (or DTensors) whose leading layer dim the axis size divides.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    x = _full(x)
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} is not divisible by num_micro "
                         f"{num_micro}")
    micro = b // num_micro

    def local_slice(leaf):
        leaf = _full(leaf)
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split over {n_stages} "
                             "stages")
        per = n // n_stages
        return leaf[stage * per:(stage + 1) * per]

    local = _tree_map(local_slice, params_stacked)
    n_local = len(next(iter(_leaves(local))))

    def local_layers(h):
        for i in range(n_local):
            h = layer_fn(_tree_map(lambda leaf: leaf[i], local), h)
        return h

    mbs = x.reshape(num_micro, micro, *x.shape[1:])
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    buf = torch.zeros_like(mbs[0])
    outputs = torch.zeros_like(mbs)
    for t in range(num_micro + n_stages - 1):
        # stage 0 injects microbatch t (if any); the others take the
        # activation received on the last tick
        h_in = mbs[min(t, num_micro - 1)] if stage == 0 else buf
        # live iff this stage is processing a real microbatch
        live = stage <= t < stage + num_micro
        h_out = local_layers(h_in) if live else buf
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= done < num_micro:
            outputs[done] = h_out
        if n_stages == 1:
            buf = h_out
            continue
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, h_out.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        buf = recv
    # outputs are valid only on the last stage: gather and select it.
    gathered = [torch.empty_like(outputs) for _ in range(n_stages)]
    dist.all_gather(gathered, outputs, group=group)
    return gathered[n_stages - 1].reshape(b, *x.shape[1:])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    """GPipe bubble overhead — the schedule-efficiency napkin number."""
    return (num_stages - 1) / (num_micro + num_stages - 1)
