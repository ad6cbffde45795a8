"""Per-row ascending sort with an int32 payload: a CUDA kernel and its
plain version.

Replaces ``repro/kernels/tile_sort.py::_bitonic_kernel`` (the Pallas
bitonic sorter). The kernel is ``csrc/tile_sort.cu``: each key is packed
with its lane as a 64-bit item, the row is padded to a power of two by
items that sort last, and the bitonic network of ``csrc/bitonic.cuh``
sorts the items in registers (``sort_layout`` says how a row is spread
over threads; ``network_schedule`` lists the sweeps it runs and the level
of each: register, warp shuffle or shared memory). The lane breaks every
tie, so the kernel returns the STABLE sort: it equals ``tile_sort_ref``
(``kernels/ref.py``) on every input, ties included, where the
reference's Pallas network leaves equal keys in no fixed order. What
bounds it and what the design does about it is in the source.

``tile_sort`` is the wrapper: CPU tensors take the plain version
(``ref.tile_sort_ref``: stable ``argsort`` + gather), CUDA tensors launch
the kernel (or raise) and add one to
``kernel_launches_total{kernel="tile_sort"}``. No render path calls it;
the reference's binning selects with ``top_k`` instead.
"""
from __future__ import annotations

import ctypes
import time
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.raster_plan import (MAX_SMEM, bitonic_sweeps,
                                             pow2_at_least)
from repro_torch.kernels.ref import tile_sort_ref
from repro_torch.obs.metrics import kernel_launches

_LAUNCHES = kernel_launches("tile_sort")

# Items per thread of a row too long for one warp; 16 past 8192 items,
# so that a row stays within 1024 threads.
ITEMS_PER_THREAD = 8
# Rows of one warp each that one CTA sorts.
WARP_ROWS_PER_CTA = 8


class SortLayout(NamedTuple):
    """How ``csrc/tile_sort.cu`` spreads a row of K keys over threads."""

    n: int             # items per row: a power of two >= K
    e: int             # items per thread (consecutive positions)
    rows_per_cta: int  # > 1 only with one warp (n / e == 32) per row
    threads: int       # per CTA
    smem: int          # bytes of shared memory per CTA


def _pad(i: int) -> int:
    return i + (i >> 5)


def sort_layout(k: int) -> SortLayout:
    """The kernel's layout for rows of ``k`` keys. Rows of up to
    32 * ITEMS_PER_THREAD items take one warp (pow2(K) padded up to 32 E,
    E = pow2(K) / 32 but at least 1), several rows to a CTA; longer rows
    take pow2(K) / E threads. Shared memory per row (as ``row_words`` in
    the source): the exchange buffer, reused for the sorted lanes and the
    values, and the raw keys. ValueError where pow2(K) items of 8 B
    exceed one CTA's shared memory (K > 16384): the network runs in one
    CTA."""
    k_pad = pow2_at_least(max(k, 1))
    if k_pad * 8 > MAX_SMEM:
        raise ValueError(f"K={k} pads to {k_pad} items of 8 B, more than "
                         f"the {MAX_SMEM} B of shared memory a CTA can use")
    if k_pad <= 32 * ITEMS_PER_THREAD:
        e = max(1, k_pad // 32)
        n, rows = 32 * e, WARP_ROWS_PER_CTA
    else:
        e = ITEMS_PER_THREAD if k_pad <= 1024 * ITEMS_PER_THREAD \
            else 2 * ITEMS_PER_THREAD
        n, rows = k_pad, 1
    x = _pad(n) + _pad(k)
    if n > 32 * e:
        x = max(x, 2 * n)
    words = ((x + 1) & ~1) + ((_pad(k) + 1) & ~1)
    return SortLayout(n, e, rows, n // e * rows, rows * words * 4)


def network_schedule(k_pad: int) -> List[Tuple[int, int, str]]:
    """The sweeps ``csrc/bitonic.cuh`` runs for rows of ``k_pad`` keys, in
    order: (span, stride, level) with level "register" (stride < E),
    "shuffle" (E <= stride < 32 E) or "shared" (stride >= 32 E). The
    network covers ``sort_layout(k_pad).n`` items."""
    lay = sort_layout(k_pad)
    return bitonic_sweeps(lay.n, lay.e)


def _c_function():
    fn = _build.load_library("tile_sort").tile_sort
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
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
    lay = sort_layout(k)
    keys = keys.contiguous()
    values = values.contiguous()
    out_k, out_v = torch.empty_like(keys), torch.empty_like(values)
    err = _c_function()(keys.data_ptr(), values.data_ptr(),
                        out_k.data_ptr(), out_v.data_ptr(), t, k, lay.n,
                        lay.e, lay.rows_per_cta,
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
    _LAUNCHES.inc()
    return out



def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("tile_sort")
    _build.load_library.cache_clear()
    _build.load_library("tile_sort")
    return time.perf_counter() - t0, report
