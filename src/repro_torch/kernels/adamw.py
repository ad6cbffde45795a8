"""AdamW on the card: one multi-tensor CUDA library for the clip norm and
the update, and the plain models of its chunking and of its norm's order.

Replaces no TPU kernel: the reference's optimizer is jnp, and the port's
plain version is ``train/optimizer.adamw_update_eager``, leaf by leaf in
eager PyTorch. ``csrc/adamw.cu`` computes the global gradient norm in two
launches and the update of every leaf in one, bound by bytes (24 an
element of a bf16 leaf, 32 of a float32 one); its design and its
arithmetic are in the source. The update rounds as the eager loop does,
operation for operation, so given the same clip scale the two give the
same bits; the norm is summed in a fixed order in double
(``global_norm_plain``), so it is within a float32 rounding of the
float64 norm and a repeat is bit-equal.

``train/optimizer.adamw_update`` asks ``route``: plain CUDA tensors on one
device take the kernel (``"kernel"``); DTensor leaves whose local tensors
are such (``"mesh"``) take the update on their local tensors, with the
norm and the clip scale the eager path's DTensor-aware ones, since a
leaf's squares add over the mesh as its placements say; CPU, fake or meta
tensors, DTensors of such, and the empty tree the eager loop; any other
CUDA case (a parameter neither bfloat16 nor float32, a gradient of another
dtype than its parameter, moments not float32, another shape, a leaf that
is not contiguous, two devices, a DTensor whose gradient or moments are
placed otherwise than its parameter) raises ``ValueError`` before any
launch, so that nothing on the card falls to the eager loop unseen.

Each call builds the leaf table (``leaf_table``: the addresses of p, g, m
and v, counts, chunks) and uploads it from pinned memory without a host
sync (torch's caching host allocator keeps the block until the copy has
run). The kernel writes through raw pointers, so the wrapper advances the
version counters of the parameters and moments, as an in-place torch
operation does. Counter: ``kernel_launches_total{kernel="adamw"}``, 3 a
call (1 on a mesh: the update alone).
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.obs.metrics import kernel_launches

_LAUNCHES = kernel_launches("adamw")

CHUNK = 32768          # elements a CTA (csrc/adamw.cu kChunk)
GROUP = 8              # elements a thread takes at a time
THREADS = 256          # a CTA of the norm and the update
FINISH_THREADS = 1024  # the norm's last CTA
WARP = 32
FIELDS = 8             # int64 a row of the leaf table
DTYPES = (torch.bfloat16, torch.float32)
PLAIN = (torch.Tensor, torch.nn.Parameter)   # tensors with memory to launch on
LAUNCHES = 3           # a call: the norm's two and the update (1 on a mesh)


class Scalars(NamedTuple):
    """A step's settings as the float32 values torch's CUDA arithmetic
    uses: Python floats rounded to float32, ``1 - b`` taken in double
    first, and the bias corrections as float32 reciprocals."""
    b1: float
    c1: float
    b2: float
    c2: float
    ib1: float
    ib2: float
    eps: float
    wd: float
    lr: float
    clip: float
    tiny: float


def scalars(cfg, lr: float, b1c: float, b2c: float) -> Scalars:
    """``cfg`` an ``OptimizerConfig``; ``lr``, ``b1c`` and ``b2c`` the
    step's learning rate and bias corrections (float32 values)."""
    f32 = np.float32
    return Scalars(*(float(x) for x in (
        f32(cfg.b1), f32(1 - cfg.b1), f32(cfg.b2), f32(1 - cfg.b2),
        f32(1) / f32(b1c), f32(1) / f32(b2c), f32(cfg.eps),
        f32(cfg.weight_decay), f32(lr), f32(cfg.clip_norm), f32(1e-9))))


def _leaves(params: Mapping[str, torch.Tensor]) -> List[str]:
    return [k for k, p in params.items() if p.numel() > 0]


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor; any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def refusal(grads: Mapping[str, torch.Tensor],
            params: Mapping[str, torch.Tensor],
            mu: Mapping[str, torch.Tensor],
            nu: Mapping[str, torch.Tensor]) -> Optional[str]:
    """Why the kernel does not take these leaves (DTensors by their local
    tensors), or None where it does."""
    names = _leaves(params)
    if not names:
        return "no leaf with elements"
    device = local(params[names[0]]).device
    meshed = isinstance(params[names[0]], DTensor)
    for k in names:
        ts = (params[k], grads[k], mu[k], nu[k])
        if any(isinstance(t, DTensor) != meshed for t in ts):
            return f"{k}: DTensors beside plain tensors"
        if meshed and any(t.device_mesh != ts[0].device_mesh
                          or t.placements != ts[0].placements for t in ts):
            return (f"{k}: a gradient or moment placed otherwise than its "
                    f"parameter ({[t.placements for t in ts]})")
        p, g, m, v = ts = tuple(local(t) for t in ts)
        if any(type(t) not in PLAIN for t in ts):
            return f"{k}: a tensor subclass (fake)"
        if any(t.device != device or t.device.type != "cuda" for t in ts):
            return (f"{k}: devices {[str(t.device) for t in ts]}, not all "
                    f"{device}")
        if p.dtype not in DTYPES:
            return f"{k}: parameter dtype {p.dtype} not in {DTYPES}"
        if g.dtype != p.dtype or m.dtype != torch.float32 \
                or v.dtype != torch.float32:
            return (f"{k}: mixed dtypes (parameter {p.dtype}, gradient "
                    f"{g.dtype}, moments {m.dtype} / {v.dtype}); the kernel "
                    f"takes the parameter's dtype for the gradient and "
                    f"float32 moments")
        if not (g.shape == m.shape == v.shape == p.shape):
            return f"{k}: shapes {[tuple(t.shape) for t in ts]} differ"
        if not all(t.is_contiguous() for t in ts):
            return f"{k}: a leaf that is not contiguous"
    return None


def route(grads, params, mu, nu) -> str:
    """Which code updates these leaves: ``"kernel"`` (plain tensors) or
    ``"mesh"`` (DTensors, by their local tensors) where ``refusal`` finds
    nothing; ``"eager"`` (the eager loop) where some tensor, or a
    DTensor's local tensor, is a subclass (fake) or lies on no CUDA device
    (CPU, meta), or where there is no leaf; raises ``ValueError`` for the
    rest."""
    ts = [t for k in params for t in (params[k], grads[k], mu[k], nu[k])]
    if not _leaves(params) or any(
            type(local(t)) not in PLAIN or local(t).device.type != "cuda"
            for t in ts):
        return "eager"
    why = refusal(grads, params, mu, nu)
    if why is None:
        return "mesh" if isinstance(ts[0], DTensor) else "kernel"
    raise ValueError(f"AdamW on the card: {why}. The kernel takes plain "
                     f"contiguous CUDA leaves on one device (or DTensors of "
                     f"such, placed alike), parameters and gradients in "
                     f"bfloat16 or float32, float32 moments")


# -- the leaf table and its chunks (plain, shared with the tests) ----------

def head(addrs: Sequence[int], sizes: Sequence[int]) -> int:
    """The least h in 0..7 at which every ``addrs[i] + h * sizes[i]`` is
    a multiple of 16 (the first element of the 16-byte aligned body), or
    0 where none is: then every chunk loads element by element."""
    for h in range(GROUP):
        if all((a + h * s) % 16 == 0 for a, s in zip(addrs, sizes)):
            return h
    return 0


def chunk_count(n: int, hd: int) -> int:
    """Chunks of a leaf of ``n`` elements whose body starts at ``hd``
    (at most n): [0, hd) where hd > 0, then CHUNK at a time."""
    if hd > 0:
        return 1 + -(-(n - hd) // CHUNK)
    return -(-n // CHUNK)


def chunk_spans(n: int, hd: int) -> List[Tuple[int, int]]:
    """[start, end) of each chunk of the leaf, as the kernel cuts them."""
    out = []
    for k in range(chunk_count(n, hd)):
        if hd > 0:
            s = 0 if k == 0 else hd + (k - 1) * CHUNK
            e = hd if k == 0 else s + CHUNK
        else:
            s, e = k * CHUNK, (k + 1) * CHUNK
        out.append((s, min(e, n)))
    return out


def leaf_table(grads, params, mu, nu, names) -> Tuple[np.ndarray, int]:
    """(the (L, FIELDS) int64 table, the chunks over all leaves); plain
    tensors (a DTensor's local ones)."""
    rows, c = [], 0
    for k in names:
        p, g, m, v = params[k], grads[k], mu[k], nu[k]
        n, z = p.numel(), p.element_size()
        hd = min(head((p.data_ptr(), g.data_ptr(), m.data_ptr(),
                       v.data_ptr()), (z, z, 4, 4)), n)
        rows.append((p.data_ptr(), m.data_ptr(), v.data_ptr(), n, c, hd,
                     int(p.dtype == torch.bfloat16), g.data_ptr()))
        c += chunk_count(n, hd)
    return np.asarray(rows, dtype=np.int64).reshape(-1, FIELDS), c


# -- the norm's order, in plain torch --------------------------------------

def _halve(x: torch.Tensor) -> torch.Tensor:
    """The halving tree a[t] += a[t + s] over the last dim (a power of
    two), as the kernel's shared-memory trees and shuffles add."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _in_order(x: torch.Tensor, width: int) -> torch.Tensor:
    """``width`` lanes, lane j adding x[j], x[j + width], ... in order
    from 0, then the halving tree over the lanes; float64."""
    pad = -x.numel() % width
    x = torch.cat([x, x.new_zeros(pad)]).reshape(-1, width)
    acc = torch.zeros(width, dtype=torch.float64, device=x.device)
    for row in x:
        acc = acc + row
    return _halve(acc)


def chunk_partial(g: torch.Tensor) -> torch.Tensor:
    """A chunk's sum of squares as ``norm_chunks`` takes it: float32
    squares summed pairwise in groups of 8, each thread's groups in order
    into a double, the CTA's halving tree. ``g`` the chunk's elements."""
    x = g.float()
    x = torch.cat([x, x.new_zeros(-x.numel() % GROUP)]).reshape(-1, GROUP)
    q = x * x
    q = (q[:, 0] + q[:, 1] + (q[:, 2] + q[:, 3])) \
        + (q[:, 4] + q[:, 5] + (q[:, 6] + q[:, 7]))
    return _in_order(q.double(), THREADS)


def global_norm_plain(grads: Sequence[torch.Tensor],
                      heads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The kernel's norm in plain torch, in its order: each chunk's
    ``chunk_partial``; a leaf's partials by 32 lanes in order and a
    halving tree; the leaf sums by 1,024 threads in order and a halving
    tree; the root in double rounded to float32. ``heads`` each leaf's
    body start (default 0)."""
    sums = []
    for i, g in enumerate(grads):
        flat = g.reshape(-1)
        hd = 0 if heads is None else heads[i]
        parts = torch.stack([chunk_partial(flat[s:e])
                             for s, e in chunk_spans(flat.numel(), hd)])
        sums.append(_in_order(parts, WARP))
    total = _in_order(torch.stack(sums), FINISH_THREADS)
    return torch.sqrt(total).float()


# -- the launches ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("adamw")
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.adamw_norm.argtypes = [ptr, i32, i64, ptr, ptr, ptr, f32, f32, ptr]
    lib.adamw_update.argtypes = [ptr, i32, i64, ptr] + [f32] * 9 + [ptr]
    for fn in (lib.adamw_norm, lib.adamw_update):
        fn.restype = ctypes.c_int
    lib.adamw_chunk_elements.restype = ctypes.c_longlong
    if lib.adamw_chunk_elements() != CHUNK:
        raise RuntimeError(f"csrc/adamw.cu cuts chunks of "
                           f"{lib.adamw_chunk_elements()} elements, the "
                           f"wrapper {CHUNK}")
    return lib


def _upload(rows: np.ndarray, device) -> torch.Tensor:
    """``rows`` on ``device`` through pinned memory, without a host sync."""
    host = torch.empty(rows.shape, dtype=torch.int64, pin_memory=True)
    host.numpy()[...] = rows
    return host.to(device, non_blocking=True)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"AdamW {what} launch failed: "
                           f"{'bad arguments' if err < 0 else 'CUDA error'} "
                           f"{err}")


def adamw(grads, params, mu, nu, k: Scalars,
          norm_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One AdamW step over every leaf, in place on the parameters and
    moments (a DTensor's on its local tensor); returns the gradient norm
    before clipping (a float32 device scalar). ``norm_scale``, where given,
    is a float32 device tensor of the norm and the clip scale, and the
    call launches the update alone; else the kernel computes both (three
    launches). The caller has had ``"kernel"`` or ``"mesh"`` from
    ``route`` for these leaves (the check takes ~8 ms of host time at 871
    leaves, so it is not made twice)."""
    p, g, m, v = ({n: local(t[n]) for n in _leaves(params)}
                  for t in (params, grads, mu, nu))
    names = [n for n in p if p[n].numel() > 0]   # a rank's shard may be empty
    if not names:
        return norm_scale[0]
    device = p[names[0]].device
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rows, n_chunks = leaf_table(g, p, m, v, names)
        table = _upload(rows, device)
        out = norm_scale
        if out is None:
            partials = torch.empty(n_chunks, dtype=torch.float64,
                                   device=device)
            sums = torch.empty(len(names), dtype=torch.float64, device=device)
            out = torch.empty(2, dtype=torch.float32, device=device)
            _check(lib.adamw_norm(table.data_ptr(), len(names), n_chunks,
                                  partials.data_ptr(), sums.data_ptr(),
                                  out.data_ptr(), k.clip, k.tiny, stream),
                   "norm")
        _check(lib.adamw_update(
            table.data_ptr(), len(names), n_chunks, out.data_ptr(), k.b1,
            k.c1, k.b2, k.c2, k.ib1, k.ib2, k.eps, k.wd, k.lr, stream),
            "update")
    torch.autograd.graph.increment_version(
        [t[n] for t in (p, m, v) for n in names])
    _LAUNCHES.inc(1 if norm_scale is not None else LAUNCHES)
    return out[0]


def build() -> tuple:
    """Compile and load the CUDA library; returns (seconds, ptxas report)."""
    t0 = time.perf_counter()
    _, report = _build.compile_library("adamw")
    _build.load_library.cache_clear()
    _library.cache_clear()
    _library()
    return time.perf_counter() - t0, report

