"""Per-tile binning + depth order (port of ``repro/core/binning.py``).

Per row of an (N, R) intersection mask (R tiles or plan slots), keep the
indices of the K = min(capacity, N) nearest intersecting Gaussians in
depth order, count the valid ones and the overflow.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.projection import ProjectedGaussians

_INF_BITS = 0x7F800000  # float32 +inf as int32 bits


class TileBins(NamedTuple):
    indices: torch.Tensor   # (T, K) int32 gaussian ids, depth-ascending
    valid: torch.Tensor     # (T, K) bool
    count: torch.Tensor     # (T,)  int32 number of valid entries (<= K)
    overflow: torch.Tensor  # (T,)  int32 pairs dropped because count > K
    capacity: int

    @property
    def total_pairs(self) -> torch.Tensor:
        return self.count.sum(dtype=torch.int32)


class TileGaussians(NamedTuple):
    """Per-tile gathered splat data — direct input to the rasterizer."""

    mean2d: torch.Tensor   # (T, K, 2)
    conic: torch.Tensor    # (T, K, 3)
    rgb: torch.Tensor      # (T, K, 3)
    opacity: torch.Tensor  # (T, K)
    depth: torch.Tensor    # (T, K)
    valid: torch.Tensor    # (T, K) bool


def _ordered_bits(depth: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 whose integer order is the float order (no NaN)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def build_tile_bins(mask_nt: torch.Tensor, depth: torch.Tensor,
                    capacity: int, *,
                    depth_limit: Optional[torch.Tensor] = None) -> TileBins:
    """Select and depth-sort up to ``capacity`` Gaussians per tile/slot.

    mask_nt: (N, T) intersection mask — or (N, R) for a plan's slots;
    depth: (N,) camera z. depth_limit: optional (T,)/(R,) per-row
    early-stop depth from DPES; pairs beyond it are dropped before the
    selection (paper Sec. IV-B).

    The reference's ``lax.top_k`` puts the lower index first among equal
    depths; here each pair's key is (depth bits << 32) | gaussian id, so
    the k smallest keys are exactly the (depth, index) order.
    """
    n = mask_nt.shape[0]
    mask_tn = mask_nt.T                                       # (T, N)
    if depth_limit is not None:
        mask_tn = mask_tn & (depth[None, :] <= depth_limit[:, None])
    ids = torch.arange(n, dtype=torch.int64, device=depth.device)
    key = torch.where(mask_tn, (_ordered_bits(depth) << 32)[None, :],
                      _INF_BITS << 32) | ids[None, :]
    k = min(capacity, n)
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    valid = (top >> 32) < _INF_BITS
    count_full = mask_tn.sum(dim=1, dtype=torch.int32)
    return TileBins(indices=(top & 0xFFFFFFFF).to(torch.int32), valid=valid,
                    count=torch.clamp_max(count_full, capacity),
                    overflow=torch.clamp_min(count_full - capacity, 0),
                    capacity=capacity)


def gather_tiles(proj: ProjectedGaussians, bins: TileBins) -> TileGaussians:
    """Gather per-tile splat attributes. (T, K, ...)."""
    idx = bins.indices.long()
    zero = torch.zeros((), dtype=proj.depth.dtype, device=idx.device)
    return TileGaussians(
        mean2d=proj.mean2d[idx], conic=proj.conic[idx], rgb=proj.rgb[idx],
        opacity=torch.where(bins.valid, proj.opacity[idx], zero),
        # Invalid entries get depth 0 (not inf): they blend with w=0 and
        # 0 * inf would poison the depth accumulators with NaN.
        depth=torch.where(bins.valid, proj.depth[idx], zero),
        valid=bins.valid)
