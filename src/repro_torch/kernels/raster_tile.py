"""Raster-only blend over depth-sorted bins: a CUDA kernel and its plain
version.

Replaces ``repro/kernels/raster_tile.py::_raster_kernel`` (the Pallas
kernel behind the reference's ``impl="pallas"``). The kernel is
``csrc/raster_tile.cu``: one CTA per tile or plan slot and one thread per
pixel; the lanes the blend can reach are read once into shared memory and
blended front to back in chunks by the blend loop the fused kernel uses
(``csrc/blend.cuh``), so on (depth, id)-sorted bins the two kernels agree
bit for bit. What bounds it and what the design does about it is in the
source.

Input contract (as the Pallas kernel's): each row's ``count`` real pairs
occupy lanes ``[0, count)`` in depth order; later lanes are padding with
opacity 0. K is a multiple of ``chunk``.

``raster_tile`` is the wrapper: CPU tensors take the plain version
(``raster_plan.raster_chunked``, the port of ``_raster_tile_chunked_jnp``),
CUDA tensors launch the kernel (or raise) and add one to
``kernel_launches_total{kernel="raster_tile"}``.
"""
from __future__ import annotations

import ctypes
import time

import torch

from repro_torch.core.camera import TILE
from repro_torch.kernels import _build
from repro_torch.kernels.raster_plan import (MAX_SMEM, check_cuda_bins,
                                             raster_chunked)
from repro_torch.obs.metrics import kernel_launches

_LAUNCHES = kernel_launches("raster_tile")

_WARPS = TILE * TILE // 32


def _check_chunk(k: int, chunk: int) -> None:
    if not 0 < chunk <= TILE * TILE:
        raise ValueError(f"chunk={chunk} must lie in [1, {TILE * TILE}] "
                         "(one pixel thread per lane of a chunk)")
    if k % chunk:
        raise ValueError(f"bin capacity K={k} must be a multiple of "
                         f"chunk={chunk}")


def _c_function():
    fn = _build.load_library("raster_tile").raster_tile
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def raster_tile_cuda(mean2d, conic, rgb, opacity, depth, origins, counts,
                     *, chunk: int = 64, tile: int = TILE):
    """Launch ``csrc/raster_tile.cu`` on CUDA tensors (no counting)."""
    if tile != TILE:
        raise ValueError(f"the CUDA kernel renders {TILE}x{TILE} tiles")
    r, k = opacity.shape
    _check_chunk(k, chunk)
    check_cuda_bins(r, k, dict(mean2d=mean2d, conic=conic, rgb=rgb,
                               opacity=opacity, depth=depth,
                               origins=origins))
    dev = opacity.device
    if dev.type != "cuda":
        raise ValueError("the tile raster kernel needs CUDA tensors")
    smem = (10 * k + _WARPS * chunk) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"K={k} needs {smem} B of shared memory per CTA; "
                         f"the card offers {MAX_SMEM}")
    counts_i = counts.to(device=dev, dtype=torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((r, tile, tile, 3), **f32),
           torch.empty((r, tile, tile), **f32),
           torch.empty((r, tile, tile), **f32),
           torch.empty((r, tile, tile), **f32),
           torch.empty((r,), dtype=torch.int32, device=dev),
           torch.empty((r, k), **f32))
    ptrs = [x.data_ptr() for x in (mean2d, conic, rgb, opacity, depth,
                                   origins, counts_i, *out)]
    err = _c_function()(*ptrs, r, k, chunk,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_tile launch failed: CUDA error {err}")
    return out


def raster_tile(mean2d, conic, rgb, opacity, depth, origins, counts, *,
                chunk: int = 64, tile: int = TILE):
    """Blend depth-sorted (R, K, ...) bins.

    Returns rgb (R, tile, tile, 3), trans, exp_depth, trunc_depth (each
    (R, tile, tile)), processed (R,) int32 = min(chunks_run*chunk, count),
    lane_contrib (R, K) float32 in lane order.
    """
    if opacity.device.type == "cpu":
        _check_chunk(opacity.shape[1], chunk)
        return raster_chunked(mean2d, conic, rgb, opacity, depth, origins,
                              counts, chunk=chunk, tile=tile)
    out = raster_tile_cuda(mean2d, conic, rgb, opacity, depth, origins,
                           counts, chunk=chunk, tile=tile)
    _LAUNCHES.inc()
    return out



def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("raster_tile")
    _build.load_library.cache_clear()
    _build.load_library("raster_tile")
    return time.perf_counter() - t0, report
