"""Temporal contribution culling for TWSR sparse frames (port of
``repro/core/culling.py``).

At each key frame the rasterizer reports, per Gaussian, the blend mass it
contributed (``RenderOutput.gauss_contrib``); Gaussians not binned into
any tile get ``inf`` (always kept), and the result rides the carry as
``FrameState.contrib``. On sparse frames culling applies only in plan
slots whose tile has usable reprojection sources
(``WarpResult.valid_per_tile > 0``) and removes intersection pairs whose
Gaussian contributed less than the threshold, before binning. Slots whose
pairs are all culled are demoted to interpolation. ``cull_threshold =
0.0`` leaves the pass out entirely (``core/pipeline.py`` branches on the
config), so the default path is unchanged.
"""
from __future__ import annotations

from typing import Tuple

import torch


def warp_gate(valid_per_tile: torch.Tensor) -> torch.Tensor:
    """(T,) warp source-pixel counts -> (T,) bool cull gate: True where
    the viewpoint transform found at least one usable source."""
    return valid_per_tile > 0


def cull_pairs(mask: torch.Tensor, slot_active: torch.Tensor,
               tile_ids: torch.Tensor, prior: torch.Tensor,
               gate: torch.Tensor, threshold: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply the contribution prior to an (N, R) intersection mask.

    mask (N, R) bool pair mask after the plan's slot masking;
    slot_active (R,) the slots' flags; tile_ids (R,) their tile ids (to
    gather the gate); prior (N,) key-frame contribution (``inf`` keeps);
    gate (T,) bool; keep a pair iff ``prior >= threshold``.

    Returns ``(mask, slot_active, culled_pairs)``: the culled mask, the
    flags with fully-culled slots demoted, and the () int32 count of
    pairs removed.
    """
    keep = prior >= threshold
    gated = gate[tile_ids.long()] & slot_active
    new_mask = mask & (keep[:, None] | ~gated[None, :])
    pre = mask.sum(dim=0, dtype=torch.int32)
    post = new_mask.sum(dim=0, dtype=torch.int32)
    culled = (pre - post).sum(dtype=torch.int32)
    demote = (pre > 0) & (post == 0)
    return new_mask, slot_active & ~demote, culled
