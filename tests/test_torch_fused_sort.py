"""The fused sort + blend kernel's sort, run here in numpy.

``csrc/raster_plan.cu`` sorts each slot's lanes as 64-bit items
(order_bits(depth) << 32 | lane) with the bitonic network of
``csrc/bitonic.cuh``; positions past the slot's count carry the largest
bits and lanes past every real lane. ``kernels/raster_plan.py`` exposes
the layout (``sort_layout``) and the sweeps (``network_schedule``); this
file runs that schedule on the kernel's items and holds the sorted lanes
exactly to the plain version's stable (depth, lane) order
(``slot_order``, which ``raster_plan_torch`` blends in), on rows with
equal depths, -0 and +0 and +inf. The kernel itself is held to the plain
version, and bit for bit to its previous build and to the tile raster
kernel, on the card by chip_smoke.py (phases 2a, 2c) and
tools/kernel_profile.py --baseline."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import raster_plan as rp
from repro_torch.kernels.raster_plan import MAX_SMEM


def _order_bits(keys):
    """bitonic::order_bits: uint32 whose order is the stable sort's order
    of float32 keys (-0 tied with +0, every NaN last)."""
    b = keys.view(np.uint32).astype(np.uint64)
    bits = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    bits = np.where(keys == 0, 0x80000000, bits)
    return np.where(np.isnan(keys), 0xFFFFFFFF, bits).astype(np.uint64)


def _kernel_order(depth_row, count, k_pad):
    """The kernel's sort of one slot in numpy: the sorted lanes of its
    first ``count`` positions. Each sweep's level must match the threads
    the kernel moves its items between."""
    lay = rp.sort_layout(count, k_pad)
    n, e = lay.n, lay.e
    pos = np.arange(n, dtype=np.uint64)
    bits = np.full(n, 0xFFFFFFFF, np.uint64)
    bits[:count] = _order_bits(depth_row[:count])
    x = (bits << np.uint64(32)) | pos
    p = np.arange(n)
    for span, stride, level in rp.network_schedule(count, k_pad):
        lo = p[(p & stride) == 0]
        hi = lo | stride
        t_lo, t_hi = lo // e, hi // e
        if level == "register":
            assert (t_lo == t_hi).all()
        elif level == "shuffle":
            assert (t_lo != t_hi).all() and (t_lo // 32 == t_hi // 32).all()
        else:
            assert level == "shared" and (t_lo // 32 != t_hi // 32).all()
            assert lay.threads > 32            # a named barrier of >1 warp
        keep_min = ((p & span) == 0) == ((p & stride) == 0)
        y = x[p ^ stride]
        x = np.where((y < x) == keep_min, y, x)
    return (x[:count] & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _depths(seed, r, k):
    """Rows of few distinct depths (many ties) with -0, +0 and +inf."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, size=(r, k)).astype(np.float32) * 0.5
    flat = d.reshape(-1)
    for i, v in enumerate((-0.0, 0.0, np.inf, -0.0, np.inf, 0.0)):
        flat[(i * 7919) % flat.size] = v
    d[:, :3] = [0.0, -0.0, np.inf]
    return d


@pytest.mark.parametrize("k,chunk", [(1024, 64), (960, 64), (100, 64),
                                     (2048, 64)])
@pytest.mark.parametrize("count", [0, 1, 63, 64, 65, 513, 1024])
def test_network_order_equals_plain_version(k, chunk, count):
    count = min(count, k)
    k_pad = rp.pow2_at_least(max(k, chunk))
    depth = _depths(k + count, 2, k)
    counts = torch.tensor([count, count // 2], dtype=torch.int32)
    real, order = rp.slot_order(torch.from_numpy(depth), counts)
    for row in range(2):
        c = int(counts[row])
        got = _kernel_order(depth[row], c, k_pad) if c else np.zeros(0)
        np.testing.assert_array_equal(got, order[row, :c].numpy())
        assert bool(real[row, :c].all()) and not bool(real[row, c:].any())


def test_empty_slot_is_not_sorted():
    assert rp.network_schedule(0, 1024) == []


@pytest.mark.parametrize("count,k_pad,levels", [
    (1024, 1024, {"register": 27, "shuffle": 25, "shared": 3}),
    (1, 1024, {"register": 21, "shuffle": 15}),
    (256, 1024, {"register": 21, "shuffle": 15}),
    (257, 1024, {"register": 24, "shuffle": 20, "shared": 1}),
    (513, 1024, {"register": 27, "shuffle": 25, "shared": 3}),
    (2048, 2048, {"register": 30, "shuffle": 30, "shared": 6}),
    (4096, 4096, {"register": 42, "shuffle": 30, "shared": 6}),
])
def test_network_levels(count, k_pad, levels):
    """At E = 8 a row of 1,024 items waits at 3 barriers (strides >= 256)
    of its 55 sweeps; rows of up to 256 items stay within one warp."""
    sched = rp.network_schedule(count, k_pad)
    n = rp.sort_layout(count, k_pad).n
    assert len(sched) == int(np.log2(n)) * (int(np.log2(n)) + 1) // 2
    got = {}
    for _, _, level in sched:
        got[level] = got.get(level, 0) + 1
    assert got == levels


def test_layout_fits_the_cta():
    """Every accepted K_pad (up to 4096 at chunk <= 256): E = 8 or 16,
    rows of whole warps within the CTA's 256 threads, n >= count, and
    the exchange buffer (8 B an item) within the record area (40 B a
    lane) it aliases; the shared memory fits the card."""
    for k_pad in (64, 128, 256, 512, 1024, 2048, 4096):
        assert rp.smem_bytes(k_pad, 256) <= MAX_SMEM
        for count in sorted({1, 31, 32, 33, k_pad // 2 + 1, k_pad}):
            lay = rp.sort_layout(count, k_pad)
            assert lay.e in (8, 16) and lay.n >= count
            assert lay.n & (lay.n - 1) == 0 and lay.n >= 32 * lay.e
            assert lay.threads == lay.n // lay.e
            assert lay.threads % 32 == 0 and lay.threads <= 256
            if lay.threads > 32:
                assert 8 * lay.n <= 16 * k_pad
    assert rp.smem_bytes(8192, 64) > MAX_SMEM
    assert rp.smem_bytes(1024, 64) == 47_104
    assert rp.items_per_thread(1024) == 8
