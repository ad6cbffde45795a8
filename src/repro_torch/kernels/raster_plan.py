"""Fused per-slot depth sort + blend: a CUDA kernel and its plain version.

Replaces ``repro/kernels/raster_plan.py::_fused_kernel`` (the Pallas
kernel behind ``raster_plan_fused``, the reference's default raster on
its accelerator). The kernel is ``csrc/raster_plan.cu``: one CTA per plan
slot and one thread per pixel; the slot's lanes are sorted by (depth,
lane) as 64-bit items in registers by the bitonic network of
``csrc/bitonic.cuh`` (``sort_layout`` says how a slot's row is spread
over threads; ``network_schedule`` lists the sweeps it runs and the level
of each), the records are read in input order into their sorted
positions, blended front to back in chunks with a CTA-wide early exit,
and each lane's contribution is reduced in a fixed order and stored to
its input lane. What bounds it and what the design does about it is in
the source.

Input contract (as the Pallas kernel's): each slot's ``count`` real pairs
occupy lanes ``[0, count)`` in ANY depth order; later lanes are padding.
``slot_active`` False, or ``count == 0``, renders the slot empty (rgb 0,
T = 1, 0 processed) and skips its sort. K is padded to a power of two
``>= chunk``; ``chunk`` must be a power of two.

``raster_plan_fused`` is the wrapper: CPU tensors take the plain version
(``raster_plan_torch``: a stable ``torch.sort`` of each slot's lanes by
(depth, lane), the chunked blend ``raster_chunked`` and the contribution
unscrambled), CUDA tensors launch the kernel (or raise) and add one to
``kernel_launches_total{kernel="raster_plan_fused"}``.
"""
from __future__ import annotations

import ctypes
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.camera import TILE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import T_EPS, alpha_of, pixel_coords
from repro_torch.obs.metrics import kernel_launches

_LAUNCHES = kernel_launches("raster_plan_fused")

# Elements of one (rows, pixels, chunk) blend temporary in raster_chunked.
_CHUNK_BLOCK = 1 << 24
# Shared memory a Hopper CTA can use (bytes).
MAX_SMEM = 232448


def pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class SortLayout(NamedTuple):
    """How ``csrc/raster_plan.cu`` spreads one slot's sort over threads."""

    n: int        # items: max(pow2(count), 32 e)
    e: int        # items per thread (consecutive positions)
    threads: int  # n / e threads of the CTA sort; rows of 32 e items: one warp


def items_per_thread(k_pad: int) -> int:
    """E of the kernel instance for rows of ``k_pad`` lanes: 8 up to 2,048,
    then 16, so that a row stays within the CTA's 256 threads."""
    return 8 if k_pad <= 2048 else 16


def sort_layout(count: int, k_pad: int) -> SortLayout:
    """The fused kernel's sort of a slot with ``count`` real lanes: positions
    past ``count`` carry items that sort last, and the row is padded to
    32 E items so that the shortest rows take one whole warp. Rows of
    ``count`` 0 (and inactive slots) are not sorted at all."""
    e = items_per_thread(k_pad)
    n = max(pow2_at_least(max(count, 1)), 32 * e)
    return SortLayout(n, e, n // e)


def bitonic_sweeps(n: int, e: int) -> List[Tuple[int, int, str]]:
    """The sweeps ``csrc/bitonic.cuh`` runs on rows of ``n`` items, ``e`` a
    thread, in order: (span, stride, level) with level "register" (stride
    < e), "shuffle" (e <= stride < 32 e) or "shared" (stride >= 32 e)."""
    out = []
    span = 2
    while span <= n:
        stride = span // 2
        while stride >= 1:
            level = ("register" if stride < e else
                     "shuffle" if stride < 32 * e else "shared")
            out.append((span, stride, level))
            stride //= 2
        span *= 2
    return out


def network_schedule(count: int, k_pad: int) -> List[Tuple[int, int, str]]:
    """The sweeps the fused kernel runs for a slot of ``count`` real lanes
    (rows of ``k_pad``): those of ``sort_layout(count, k_pad)``'s row;
    none for an empty slot."""
    if count <= 0:
        return []
    lay = sort_layout(count, k_pad)
    return bitonic_sweeps(lay.n, lay.e)


def smem_bytes(k_pad: int, chunk: int) -> int:
    """Shared memory of one CTA: the packed records (10 words a lane), the
    rank of each input lane (1) and the warp partials (8 chunk); the
    sort's exchange buffer aliases the records."""
    return (11 * k_pad + 8 * chunk) * 4


def _check_chunk(chunk: int) -> None:
    if chunk <= 0 or chunk & (chunk - 1):
        raise ValueError(f"chunk={chunk} must be a power of two")


def raster_chunked(mean2d, conic, rgb, opacity, depth, origins, counts, *,
                   chunk: int, tile: int = TILE,
                   work: Optional[dict] = None):
    """Chunked front-to-back blend over depth-sorted (R, K) lanes.

    Port of ``repro/kernels/ops.py::_raster_tile_chunked_jnp``, batched
    over R: inside a chunk the transmittance is a cumulative product,
    across chunks ``done`` is sticky. Lanes past a slot's count must have
    opacity 0. Returns rgb (R,tile,tile,3), trans, exp_depth, trunc_depth
    (R,tile,tile), processed (R,) int32 = min(alive_chunks*chunk, count),
    lane_contrib (R,K).

    ``work``, when given a dict, receives the work the function needs on
    these inputs: ``"evaluated"``, the (pixel, real lane) pairs reached
    while the pixel is not yet done (T before the lane >= T_EPS),
    ``"blended"``, the pairs with a nonzero blend weight, and
    ``"warp_chunks"``, the (32-pixel warp, chunk below the slot's count)
    pairs that start with a pixel of the warp not yet done: the chunks
    the CUDA blend's warps run, each over 32 pixels and ``chunk`` lanes
    (a warp whose pixels are all done skips the chunk).
    """
    r, k = opacity.shape
    if k % chunk:
        raise ValueError(f"bin capacity K={k} must be a multiple of "
                         f"chunk={chunk}")
    p = tile * tile
    dev = opacity.device
    f32 = dict(dtype=torch.float32, device=dev)
    rgb_o = torch.zeros((r, p, 3), **f32)
    trans_o = torch.ones((r, p), **f32)
    depth_o = torch.zeros((r, p), **f32)
    tdepth_o = torch.zeros((r, p), **f32)
    processed = torch.zeros((r,), dtype=torch.int32, device=dev)
    contrib = torch.zeros((r, k), **f32)
    # Chunks past the largest count hold only zero-opacity lanes: they
    # change no pixel, and processed is capped by count anyway.
    max_count = int(counts.max()) if r else 0
    n_used = min(-(-max_count // chunk), k // chunk)
    rows = max(1, _CHUNK_BLOCK // (p * chunk))
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    n_blend = torch.zeros((), dtype=torch.int64, device=dev)
    n_warp = torch.zeros((), dtype=torch.int64, device=dev)
    for r0 in range(0, r, rows):
        b = slice(r0, r0 + rows)
        px, py = pixel_coords(origins[b], tile)          # (B, P)
        nb = px.shape[0]
        c_acc = torch.zeros((nb, p, 3), **f32)
        t_run = torch.ones((nb, p), **f32)
        done = torch.zeros((nb, p), dtype=torch.bool, device=dev)
        d_acc = torch.zeros((nb, p), **f32)
        w_acc = torch.zeros((nb, p), **f32)
        td_max = torch.zeros((nb, p), **f32)
        n_alive = torch.zeros((nb,), dtype=torch.int32, device=dev)
        for i in range(n_used):
            sl = slice(i * chunk, (i + 1) * chunk)
            alive = (~done).any(dim=1)
            m = mean2d[b, sl]
            con = conic[b, sl]
            dep = depth[b, sl][:, None, :]
            dx = px[:, :, None] - m[:, None, :, 0]           # (B, P, G)
            dy = py[:, :, None] - m[:, None, :, 1]
            power = (-0.5 * (con[:, None, :, 0] * dx * dx
                             + con[:, None, :, 2] * dy * dy)
                     - con[:, None, :, 1] * dx * dy)
            alpha = alpha_of(opacity[b, sl][:, None, :], power)
            cp = torch.cumprod(1.0 - alpha, dim=2)
            tp = t_run[..., None] * cp
            t_before = t_run[..., None] * torch.cat(
                [torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=2)
            blend = (tp >= T_EPS) & ~done[..., None]     # sticky done
            w = torch.where(blend, alpha * t_before, torch.zeros_like(alpha))
            if work is not None:
                lane = torch.arange(i * chunk, (i + 1) * chunk, device=dev)
                real = lane[None, :] < counts[b, None]
                n_eval += ((t_before >= T_EPS) & ~done[..., None]
                           & real[:, None, :]).sum()
                n_blend += (w > 0).sum()
                n_warp += ((~done).reshape(nb, -1, 32).any(dim=2)
                           & (i * chunk < counts[b])[:, None]).sum()
            c_acc = c_acc + w @ rgb[b, sl]
            d_acc = d_acc + (w * dep).sum(dim=2)
            w_acc = w_acc + w.sum(dim=2)
            td_max = torch.maximum(td_max, torch.where(
                blend & (alpha > 0.0), dep, torch.zeros_like(w)).amax(dim=2))
            t_run = torch.where(blend, tp, t_run[..., None]).amin(dim=2)
            done = done | (tp[..., -1] < T_EPS)
            n_alive += alive.to(torch.int32)
            contrib[b, sl] = w.sum(dim=1)
        rgb_o[b] = c_acc
        trans_o[b] = t_run
        depth_o[b] = d_acc / torch.clamp_min(w_acc, 1e-8)
        tdepth_o[b] = td_max
        processed[b] = torch.minimum(n_alive * chunk,
                                     counts[b].to(torch.int32))
    if work is not None:
        work["evaluated"] = int(n_eval)
        work["blended"] = int(n_blend)
        work["warp_chunks"] = int(n_warp)
    shape = (r, tile, tile)
    return (rgb_o.reshape(r, tile, tile, 3), trans_o.reshape(shape),
            depth_o.reshape(shape), tdepth_o.reshape(shape), processed,
            contrib)


def slot_order(depth, counts):
    """(real, order) of the plain version: ``real`` (R, K) marks lanes below
    each slot's count (in input and in sorted order alike), ``order`` (R,
    K) lists each slot's lanes by the stable sort of (depth, lane) with
    padding keyed +inf: the order the fused kernel blends in."""
    lane = torch.arange(depth.shape[1], device=depth.device)
    real = lane[None, :] < counts[:, None]
    key = torch.where(real, depth, torch.full_like(depth, float("inf")))
    return real, torch.sort(key, dim=1, stable=True).indices


def raster_plan_torch(mean2d, conic, rgb, opacity, depth, origins, counts,
                      slot_active=None, *, chunk: int = 64, tile: int = TILE,
                      work: Optional[dict] = None):
    """Plain version of the fused kernel (same inputs and outputs).

    Sorts each slot's lanes stably by (depth, lane) with padding keyed
    +inf, pads K to the kernel's power of two, runs ``raster_chunked`` and
    returns ``lane_contrib`` in input lane order. ``work`` is passed on to
    ``raster_chunked``.
    """
    _check_chunk(chunk)
    r, k = opacity.shape
    if slot_active is None:
        slot_active = counts > 0
    counts = torch.where(slot_active, counts.to(torch.int32),
                         torch.zeros_like(counts, dtype=torch.int32))
    k_pad = pow2_at_least(max(k, chunk))
    real, order = slot_order(depth, counts)

    def take(x):
        idx = order if x.dim() == 2 else order[..., None].expand_as(x)
        y = torch.take_along_dim(x, idx, dim=1)
        mask = real if x.dim() == 2 else real[..., None]
        y = torch.where(mask, y, torch.zeros_like(y))
        pad = [0, 0] * (x.dim() - 2) + [0, k_pad - k]
        return torch.nn.functional.pad(y, pad)

    rgb_o, trans_o, depth_o, tdepth_o, processed, contrib_sorted = \
        raster_chunked(take(mean2d), take(conic), take(rgb), take(opacity),
                       take(depth), origins, counts, chunk=chunk, tile=tile,
                       work=work)
    contrib = torch.zeros((r, k), dtype=torch.float32, device=opacity.device)
    contrib.scatter_(1, order, contrib_sorted[:, :k])
    return rgb_o, trans_o, depth_o, tdepth_o, processed, contrib


def check_cuda_bins(r, k, tensors):
    """Raise unless each (R, K, ...) bin tensor has its shape, is float32,
    contiguous and on opacity's device."""
    shapes = {"mean2d": (r, k, 2), "conic": (r, k, 3), "rgb": (r, k, 3),
              "opacity": (r, k), "depth": (r, k), "origins": (r, 2)}
    dev = tensors["opacity"].device
    for name, x in tensors.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                             f"{shapes[name]}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype} != torch.float32")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, opacity on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _c_function():
    fn = _build.load_library("raster_plan").raster_plan_fused
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def raster_plan_cuda(mean2d, conic, rgb, opacity, depth, origins, counts,
                     slot_active, *, chunk: int = 64, tile: int = TILE):
    """Launch ``csrc/raster_plan.cu`` on CUDA tensors (no counting)."""
    _check_chunk(chunk)
    if tile != TILE:
        raise ValueError(f"the CUDA kernel renders {TILE}x{TILE} tiles")
    if chunk > TILE * TILE:
        raise ValueError(f"chunk={chunk} exceeds the CTA's {TILE * TILE} "
                         "threads")
    r, k = opacity.shape
    check_cuda_bins(r, k, dict(mean2d=mean2d, conic=conic, rgb=rgb,
                                  opacity=opacity, depth=depth,
                                  origins=origins))
    dev = opacity.device
    if dev.type != "cuda":
        raise ValueError("the fused raster kernel needs CUDA tensors")
    k_pad = pow2_at_least(max(k, chunk))
    smem = smem_bytes(k_pad, chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"K={k} needs {smem} B of shared memory per CTA; "
                         f"the card offers {MAX_SMEM}")
    counts_i = counts.to(device=dev, dtype=torch.int32).contiguous()
    active_i = slot_active.to(device=dev, dtype=torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((r, tile, tile, 3), **f32),
           torch.empty((r, tile, tile), **f32),
           torch.empty((r, tile, tile), **f32),
           torch.empty((r, tile, tile), **f32),
           torch.empty((r,), dtype=torch.int32, device=dev),
           torch.empty((r, k), **f32))
    ptrs = [x.data_ptr() for x in (mean2d, conic, rgb, opacity, depth,
                                   origins, counts_i, active_i, *out)]
    err = _c_function()(*ptrs, r, k, k_pad, chunk,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_plan_fused launch failed: CUDA error "
                           f"{err}")
    return out


def raster_plan_fused(mean2d, conic, rgb, opacity, depth, origins, counts,
                      slot_active=None, *, chunk: int = 64,
                      tile: int = TILE):
    """Fused sort+blend over plan slots. Inputs (R, K, ...) packed bins.

    Returns rgb (R, tile, tile, 3), trans, exp_depth, trunc_depth (each
    (R, tile, tile)), processed (R,) int32 = min(chunks_run*chunk, count),
    lane_contrib (R, K) float32 in INPUT lane order. ``slot_active`` (R,)
    bool defaults to ``counts > 0``.
    """
    _check_chunk(chunk)
    if slot_active is None:
        slot_active = counts > 0
    if opacity.device.type == "cpu":
        return raster_plan_torch(mean2d, conic, rgb, opacity, depth, origins,
                                 counts, slot_active, chunk=chunk, tile=tile)
    out = raster_plan_cuda(mean2d, conic, rgb, opacity, depth, origins,
                           counts, slot_active, chunk=chunk, tile=tile)
    _LAUNCHES.inc()
    return out



def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("raster_plan")
    _build.load_library.cache_clear()
    _build.load_library("raster_plan")
    return time.perf_counter() - t0, report
