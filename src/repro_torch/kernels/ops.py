"""Public raster and preprocess entry points (port of
``repro/kernels/ops.py``).

``raster_tiles`` takes ``impl``:
  - "cuda_fused"    : the fused per-slot sort + blend kernel
                      (kernels/raster_plan.py, csrc/raster_plan.cu) — the
                      default on CUDA tensors; on CPU tensors its plain
                      version runs (sort, chunked blend, unscramble)
  - "cuda"          : the blend over depth-sorted bins in CUDA
                      (kernels/raster_tile.py, csrc/raster_tile.cu; the
                      port of the reference's "pallas"); on CPU tensors
                      its plain version runs (``raster_chunked``)
  - "torch_chunked" : the chunked blend over depth-sorted bins in torch
                      (the port of ``_raster_tile_chunked_jnp``, kept in
                      kernels/raster_plan.py beside the kernel whose blend
                      it mirrors) — the default on CPU tensors
  - "ref"           : the sequential oracle (kernels/ref.py)
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.camera import TILE
from repro_torch.kernels import ref as ref_kernels
from repro_torch.kernels.preprocess import pallas_layout
from repro_torch.kernels.preprocess import preprocess_geom as _preprocess
from repro_torch.kernels.raster_plan import raster_chunked, raster_plan_fused
from repro_torch.kernels.raster_tile import raster_tile
from repro_torch.obs.trace import annotate

# Valid ``impl`` names for raster_tiles, in preference order.
RASTER_IMPLS = ("cuda_fused", "cuda", "torch_chunked", "ref")


def default_impl(device) -> str:
    """The raster ``impl`` for tensors on ``device``: the fused kernel on
    CUDA, the chunked torch blend everywhere else."""
    return "cuda_fused" if torch.device(device).type == "cuda" \
        else "torch_chunked"


def raster_tiles(mean2d, conic, rgb, opacity, depth, origins, counts, *,
                 impl: Optional[str] = None, chunk: int = 64,
                 tile: int = TILE, slot_active=None):
    """Rasterize a batch of tiles: inputs (R, K, ...) -> 6 outputs.

    Returns (rgb, transmittance, expected_depth, truncated_depth,
    processed_pairs, lane_contrib): ``processed_pairs`` (R,) int32 pairs
    traversed before the early-stop exit (chunk-granular for the chunked
    impls, exact for ref); ``lane_contrib`` (R, K) float32 per-lane sum of
    ``alpha * T_before`` over the tile's pixels, in INPUT lane order on
    every impl, 0 for padding / masked / never-blended lanes.

    ``impl=None`` picks ``default_impl`` for the inputs' device.
    ``slot_active`` (R,) bool is consumed by "cuda_fused" only. Contract:
    an inactive slot has ``counts == 0``, so every impl renders it empty.
    """
    impl = impl or default_impl(opacity.device)
    with annotate(f"repro.raster/{impl}"):
        if impl == "cuda_fused":
            return raster_plan_fused(mean2d, conic, rgb, opacity, depth,
                                     origins, counts, slot_active,
                                     chunk=chunk, tile=tile)
        if impl == "cuda":
            return raster_tile(mean2d, conic, rgb, opacity, depth, origins,
                               counts, chunk=chunk, tile=tile)
        if impl == "torch_chunked":
            return raster_chunked(mean2d, conic, rgb, opacity, depth,
                                  origins, counts, chunk=chunk, tile=tile)
        if impl == "ref":
            return ref_kernels.raster_tiles_ref(mean2d, conic, rgb, opacity,
                                                depth, origins, tile=tile)
    raise ValueError(f"unknown impl {impl!r}")


def preprocess_geom(means, log_scales, quats, opacity, w2c,
                    intrin: Sequence[float], *, impl: str = "cuda"):
    """Preprocess geometry in the Pallas kernel's layout.

    Returns mean2d (N,2), conic (N,3), depth (N,), aux (N,6) = [radius3,
    r_major, r_minor, half_w, half_h, valid], minor_axis (N,2).
    ``impl="cuda"`` goes through the kernel wrapper (its plain version on
    CPU tensors); ``impl="ref"`` is the oracle.
    """
    if impl == "ref":
        return ref_kernels.preprocess_geom_ref(means, log_scales, quats,
                                               opacity, w2c, intrin)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}")
    return pallas_layout(_preprocess(means, log_scales, quats, opacity, w2c,
                                     intrin))
