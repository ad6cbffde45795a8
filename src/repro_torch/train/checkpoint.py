"""Fault-tolerant checkpointing: atomic, validated against a template (the
port of the reference's ``train/checkpoint.py``).

Layout per step:  <dir>/step_<n>/arrays.npz + manifest.json
  - the write goes to a tmp dir and then ``os.rename`` (atomic on POSIX):
    a crash mid-write never corrupts the latest checkpoint;
  - the manifest carries the flattened key paths, each leaf's dtype, the
    step and user metadata, so restore validates structure instead of
    trusting pickles;
  - keys are the reference's (``.params/layers/0/attn/wq``,
    ``.opt/.step``, ``.opt/.mu/layers/0/attn/wq``: NamedTuple fields as
    ``.name``, a parameter name's dots as ``/``),
    so either package's float32 checkpoint of the unstacked layer layout
    loads into the other's template.

numpy has no bfloat16: a bfloat16 leaf is stored as its raw 16-bit
patterns (int16) and its manifest dtype says how to read them back, so a
restore is bit-exact.

On a mesh: ``save`` writes each DTensor leaf as its full tensor, in the
same layout and keys, so nothing about the mesh is persisted; every rank
joins each leaf's gather, rank 0 writes, and a barrier follows.
``restore(..., shardings=...)`` places every leaf by the TARGET
``Sharding`` (``distributed.sharding.param_shardings`` of the template):
loading onto a different mesh (elastic re-mesh) is just other
shardings.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as S

def _path(name: str) -> str:
    """A parameter name (``layers.0.attn.wq``) as a key path."""
    return name.replace(".", "/")


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of NamedTuples, dicts, modules (their named parameters)
    and leaves (tensors, ints and ``Sharding`` records)."""
    if isinstance(tree, S.Sharding):
        yield prefix[:-1], tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}.{f}/")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{_path(k)}/")
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{prefix}{_path(name)}", p
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, a.dtype.name
    t = leaf.detach().cpu()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), dtype


def save(ckpt_dir: str, step: int, tree, *, metadata: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomically persist ``tree``; prunes old steps beyond ``keep``.
    Leaves are written one at a time (an ``np.savez`` archive, streamed),
    so the host holds one leaf, not the tree. A tree with DTensor leaves
    is saved by every rank of their mesh together (rank 0 writes)."""
    leaves = list(_leaves(tree))
    mesh = next((x.device_mesh for _, x in leaves
                 if isinstance(x, DTensor)), None)
    writer = mesh is None or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = None
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        dtypes = {}
        with (zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                              zipfile.ZIP_STORED, allowZip64=True)
              if writer else contextlib.nullcontext()) as zf:
            for k, leaf in leaves:
                if isinstance(leaf, DTensor):
                    leaf = leaf.full_tensor()   # every rank joins
                if not writer:
                    continue
                a, dtypes[k] = _to_numpy(leaf)
                with zf.open(f"{k}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, a, allow_pickle=False)
                del a
        if writer:
            manifest = {"step": step, "keys": sorted(dtypes),
                        "dtypes": dtypes, "metadata": metadata or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
    except BaseException:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    if writer:
        _prune(ckpt_dir, keep)
    if mesh is not None:
        dist.barrier()
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.startswith(".")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, saved_dtype: Optional[str], like,
                device, sharding=None) -> Any:
    """A saved array as a leaf like the template's ``like``: a tensor of
    its dtype on ``device`` (or its own), placed by ``sharding`` when
    one is given, or a Python int."""
    if not isinstance(like, torch.Tensor):
        return type(like)(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if saved_dtype is not None and saved_dtype != arr.dtype.name:
        t = t.view(getattr(torch, saved_dtype))
    if sharding is not None:
        dev = torch.device(sharding.mesh.device_type)
        return S.place(t.to(device=dev, dtype=like.dtype), sharding)
    dev = like.device if device is None else torch.device(device)
    return t.to(device=dev, dtype=like.dtype)


def _rebuild(tree, prefix: str, values: Dict[str, Any]):
    """``tree`` with its leaves taken from ``values``; a module's
    parameters are replaced by new ones holding the restored tensors
    (``requires_grad`` as before)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), f"{prefix}.{f}/",
                                     values) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}{_path(k)}/", values)
                for k, v in tree.items()}
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(tree.get_submodule(owner), leaf, nn.Parameter(
                values[f"{prefix}{_path(name)}"],
                requires_grad=p.requires_grad))
        return tree
    return values[prefix[:-1]]


def restore(ckpt_dir: str, template, *, step: Optional[int] = None,
            device=None, shardings=None):
    """Load into the structure of ``template`` (a tree as ``save`` takes;
    its tensors may live on the ``meta`` device, which allocates nothing;
    its modules' parameters are replaced by the restored ones).

    Each leaf takes the template leaf's dtype and is placed on ``device``
    (default: the template leaf's), or, with ``shardings`` (a tree
    congruent with ``template``, as ``param_shardings`` gives), on its
    ``Sharding``'s mesh: the elastic re-mesh path. Missing or extra keys raise
    ``ValueError("checkpoint/template mismatch ...")``, a shape that
    differs raises ValueError. Returns (tree, step, metadata).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})

    flat_template = dict(_leaves(template))
    missing = set(flat_template) - set(manifest["keys"])
    extra = set(manifest["keys"]) - set(flat_template)
    if missing or extra:
        raise ValueError(f"checkpoint/template mismatch: missing="
                         f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    flat_shard = {} if shardings is None else dict(_leaves(shardings))
    values = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, like in flat_template.items():
            arr = data[key]
            shape = tuple(like.shape) if isinstance(like, torch.Tensor) \
                else np.shape(like)
            if arr.shape != shape:
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
            values[key] = _from_numpy(arr, dtypes.get(key), like, device,
                                      flat_shard.get(key))
    return _rebuild(template, "", values), step, manifest["metadata"]
