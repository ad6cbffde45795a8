"""Per-row ascending sort with an int32 payload: a CUDA kernel and its
plain version.

Replaces ``repro/kernels/tile_sort.py::_bitonic_kernel`` (the Pallas
bitonic sorter). The kernel is ``csrc/tile_sort.cu``: one CTA per row, a
bitonic network over (key, lane) items in shared memory with the row
padded to a power of two by items that sort last. The lane breaks every
tie, so the kernel returns the STABLE sort: it equals ``tile_sort_ref``
(``kernels/ref.py``) on every input, ties included, where the
reference's Pallas network leaves equal keys in no fixed order. What
bounds it and what the design does about it is in the source.

``tile_sort`` is the wrapper: CPU tensors take the plain version
(``ref.tile_sort_ref``: stable ``argsort`` + gather), CUDA tensors launch
the kernel (or raise) and add one to ``tile_sort.launches``. No render
path calls it; the reference's binning selects with ``top_k`` instead.
"""
from __future__ import annotations

import ctypes
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.raster_plan import MAX_SMEM, pow2_at_least
from repro_torch.kernels.ref import tile_sort_ref


def _c_function():
    fn = _build.load_library("tile_sort").tile_sort
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(keys: torch.Tensor, values: torch.Tensor) -> None:
    if keys.dim() != 2 or tuple(values.shape) != tuple(keys.shape):
        raise ValueError(f"keys {tuple(keys.shape)} and values "
                         f"{tuple(values.shape)} must be one (T, K) shape")
    if keys.dtype != torch.float32 or values.dtype != torch.int32:
        raise TypeError(f"keys must be float32 and values int32, got "
                        f"{keys.dtype} and {values.dtype}")
    if values.device != keys.device:
        raise ValueError(f"values on {values.device}, keys on {keys.device}")


def tile_sort_cuda(keys: torch.Tensor, values: torch.Tensor):
    """Launch ``csrc/tile_sort.cu`` on CUDA tensors (no counting)."""
    _check_inputs(keys, values)
    if keys.device.type != "cuda":
        raise ValueError("the tile sort kernel needs CUDA tensors")
    t, k = keys.shape
    k_pad = pow2_at_least(max(k, 1))
    if k_pad * 8 > MAX_SMEM:
        raise ValueError(f"K={k} needs {k_pad * 8} B of shared memory per "
                         f"CTA; the card offers {MAX_SMEM}")
    keys = keys.contiguous()
    values = values.contiguous()
    out_k, out_v = torch.empty_like(keys), torch.empty_like(values)
    err = _c_function()(keys.data_ptr(), values.data_ptr(),
                        out_k.data_ptr(), out_v.data_ptr(), t, k, k_pad,
                        torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_sort launch failed: CUDA error {err}")
    return out_k, out_v


def tile_sort(keys: torch.Tensor, values: torch.Tensor):
    """Sort each row of keys (T, K) float32 ascending, stably, with its
    int32 values. Returns sorted (keys, values)."""
    if keys.device.type == "cpu":
        _check_inputs(keys, values)
        return tile_sort_ref(keys, values)
    out = tile_sort_cuda(keys, values)
    tile_sort.launches += 1
    return out


tile_sort.launches = 0


def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("tile_sort")
    _build.load_library.cache_clear()
    _build.load_library("tile_sort")
    return time.perf_counter() - t0, report
