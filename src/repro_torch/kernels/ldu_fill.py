"""The LDU's tile -> block fills (paper Sec. V-B): a CUDA kernel and its
plain version.

Replaces the reference's on-device scans of
``repro/core/load_balance.py`` — ``greedy_fill`` (the paper's capacity
fill, a ``lax.scan``) and the ``"dynamic"`` scan of ``ldu_schedule``
(least-loaded block). Neither is a Pallas kernel; in the reference they
run inside the jitted frame with no host callback, and here they run in
``csrc/ldu_fill.cu``: one launch of one warp that places the active
slots one a step (a ballot of each group of 32 flags gives the steps),
keeps the current block's accumulator in a register and every block's in
shared memory, lane ``l`` owning blocks ``l, l + 32, ...``, and decides
a deferral by warp min-reduces (the least cyclic rank of the blocks with
room, else the least (load, index)). What bounds it is in the source.

Both versions keep float32 accumulators and compute the cap with float32
operations in the reference's order; the active total is summed exactly
and rounded to float32 once. Mode ``"greedy"``: a slot joins the current
block unless that would pass the cap, then the first block with room in
cyclic order from the next one, else the least-loaded block (lowest
index on ties). Mode ``"dynamic"``: every slot to the least-loaded block.
Inactive slots get -1.

``ldu_fill`` is the wrapper: CPU tensors take the plain version
(``ldu_fill_host``, a numpy scan on the host), CUDA tensors launch the
kernel (or raise) and add one to
``kernel_launches_total{kernel="ldu_fill"}``; a CUDA call copies nothing
to the host.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.obs.metrics import kernel_launches

_LAUNCHES = kernel_launches("ldu_fill")

MODES = ("greedy", "dynamic")


def fill_cap(workload: np.ndarray, active: np.ndarray, b: int):
    """The greedy fill's float32 cap: ``(1 + 1/n_avg) * w_ideal`` with
    ``w_ideal = max(total / b, 1)`` and ``n_avg = max(n_active / b, 1)``;
    ``workload`` is the float32 (R,) workload."""
    f32 = np.float32
    total = f32(workload[active].astype(np.float64).sum())
    w_ideal = max(total / f32(b), f32(1.0))
    n_avg = max(f32(active.sum()) / f32(b), f32(1.0))
    return (f32(1.0) + f32(1.0) / n_avg) * w_ideal


def ldu_fill_host(workload: torch.Tensor, active: torch.Tensor,
                  num_blocks: int, mode: str = "greedy") -> torch.Tensor:
    """Plain version: the fill as a numpy scan over a host copy of the
    (R,) workload. Returns (R,) int32 on the input's device."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    b = max(int(num_blocks), 1)
    # The reference's int32 entry cast, then float32 like its scan.
    wl = workload.to(torch.int32).cpu().numpy().astype(np.float32)
    act = active.to(torch.bool).cpu().numpy()
    accs = np.zeros((b,), np.float32)
    out = np.full(wl.shape, -1, np.int32)
    if mode == "dynamic":
        for i in np.flatnonzero(act):
            j = int(np.argmin(accs))
            accs[j] += wl[i]
            out[i] = j
        return torch.from_numpy(out).to(workload.device)
    cap = fill_cap(wl, act, b)
    cur = 0
    for i in np.flatnonzero(act):
        w = wl[i]
        if accs[cur] + w > cap:
            cand = (cur + 1 + np.arange(b)) % b
            fits = accs[cand] + w <= cap
            cur = int(cand[np.argmax(fits)]) if fits.any() \
                else int(np.argmin(accs))
        accs[cur] += w
        out[i] = cur
    return torch.from_numpy(out).to(workload.device)


def _c_function():
    fn = _build.load_library("ldu_fill").ldu_fill
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(num_blocks: int) -> int:
    """Shared memory of one launch, as the built library computes it: the
    B accumulators and a staged chunk of slots."""
    fn = _build.load_library("ldu_fill").ldu_fill_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(max(int(num_blocks), 1))


def _check_inputs(workload: torch.Tensor, active: torch.Tensor,
                  mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if workload.dim() != 1 or tuple(active.shape) != tuple(workload.shape):
        raise ValueError(f"workload {tuple(workload.shape)} and active "
                         f"{tuple(active.shape)} must be one (R,) shape")
    if active.device != workload.device:
        raise ValueError(f"active on {active.device}, workload on "
                         f"{workload.device}")


def ldu_fill_cuda(workload: torch.Tensor, active: torch.Tensor,
                  num_blocks: int, mode: str = "greedy") -> torch.Tensor:
    """Launch ``csrc/ldu_fill.cu`` on CUDA tensors (no counting)."""
    _check_inputs(workload, active, mode)
    if workload.device.type != "cuda":
        raise ValueError("the LDU fill kernel needs CUDA tensors")
    b = max(int(num_blocks), 1)
    wl = workload.to(torch.int32).contiguous()
    act = active.to(torch.bool).contiguous()
    out = torch.empty(wl.shape, dtype=torch.int32, device=wl.device)
    r = wl.shape[0]
    if r == 0:
        return out
    err = _c_function()(wl.data_ptr(), act.data_ptr(), out.data_ptr(), r, b,
                        int(mode == "dynamic"),
                        torch.cuda.current_stream(wl.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ldu_fill launch failed: CUDA error {err}")
    return out


def ldu_fill(workload: torch.Tensor, active: torch.Tensor, num_blocks: int,
             mode: str = "greedy") -> torch.Tensor:
    """(R,) int32 block per slot (-1 inactive) of the ``mode`` fill over
    the slots in order. ``workload`` (R,) integer pairs, ``active`` (R,)
    bool."""
    if workload.device.type == "cpu":
        _check_inputs(workload, active, mode)
        return ldu_fill_host(workload, active, num_blocks, mode)
    out = ldu_fill_cuda(workload, active, num_blocks, mode)
    if workload.shape[0]:
        _LAUNCHES.inc()
    return out



def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("ldu_fill")
    _build.load_library.cache_clear()
    _build.load_library("ldu_fill")
    return time.perf_counter() - t0, report
