"""DPES — Depth Prediction for Early Stopping (port of
``repro/core/dpes.py``, paper Sec. IV-B).

The reference frame's truncated depth map (depth at which blending
early-stopped, produced by the rasterizer) is reprojected by
``warp.viewpoint_transform``; this module turns the per-tile early-stop
depths into (a) pre-sort Gaussian culling and (b) per-tile *workload
predictions* for the LDU (Sec. V-B). Works on tensors of any device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TileWorkload(NamedTuple):
    raw: torch.Tensor        # (T,) int32 pairs per tile before DPES
    predicted: torch.Tensor  # (T,) int32 pairs per tile after DPES culling
    culled: torch.Tensor     # (T,) int32 pairs removed by DPES


def apply_depth_limit(mask_nt: torch.Tensor, depth: torch.Tensor,
                      dpes_depth: torch.Tensor, *,
                      margin: float = 1.0) -> torch.Tensor:
    """Cull (gaussian, tile) pairs beyond the tile's early-stop depth.

    mask_nt: (N, T) bool; depth: (N,); dpes_depth: (T,) with inf = no
    prior. ``margin`` scales the limit (1.0 = faithful to the paper).
    """
    limit = dpes_depth * margin
    return mask_nt & (depth[:, None] <= limit[None, :])


def predict_workload(mask_nt: torch.Tensor, depth: torch.Tensor,
                     dpes_depth: torch.Tensor, *,
                     margin: float = 1.0) -> TileWorkload:
    """Per-tile effective workload estimate (pairs surviving DPES)."""
    raw = mask_nt.sum(dim=0, dtype=torch.int32)
    culled_mask = apply_depth_limit(mask_nt, depth, dpes_depth, margin=margin)
    predicted = culled_mask.sum(dim=0, dtype=torch.int32)
    return TileWorkload(raw=raw, predicted=predicted, culled=raw - predicted)
