"""The tile sorter's plain version against the JAX reference on the CPU:
``tile_sort_ref`` on rows with ties (exact: both are stable sorts), and
``tile_sort_pallas`` in interpret mode on distinct keys at the reference
suite's small (4, 16) cases (its network is not stable on ties). The
kernel's network, as ``network_schedule`` lists it, runs here in numpy
on the kernel's 64-bit (key bits, lane) items and must give the
reference's stable sort. The kernel itself is held to the plain version
on the card by phase 2d of chip_smoke.py (ties, -0, NaN, odd K, K = 1,
K = 4096 and 16384, and a key frame's rows)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.kernels import ref as jref
from repro.kernels.tile_sort import tile_sort_pallas
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tile_sort as ts
from repro_torch.kernels.raster_plan import MAX_SMEM
from repro_torch.obs.metrics import kernel_launches


def _rows(seed, t, k, *, ties):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 6, size=(t, k)).astype(np.float32) if ties \
        else rng.permutation(t * k).reshape(t, k).astype(np.float32) / 7.0
    vals = rng.integers(-1000, 1000, size=(t, k)).astype(np.int32)
    return keys, vals


@pytest.mark.parametrize("t,k", [(4, 16), (3, 100), (2, 1024)])
def test_plain_matches_stable_oracle_with_ties(t, k):
    keys, vals = _rows(t * k, t, k, ties=True)
    keys[0, :3] = [np.inf, -0.0, 0.0]
    before = kernel_launches("tile_sort").value
    got = ts.tile_sort(torch.from_numpy(keys), torch.from_numpy(vals))
    want = jref.tile_sort_ref(jnp.asarray(keys), jnp.asarray(vals))
    for g, w in zip(got, want):
        P.assert_equal(g, w)
    # CPU: the plain version
    assert kernel_launches("tile_sort").value == before


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_on_distinct_keys(seed):
    keys, vals = _rows(seed, 4, 16, ties=False)
    got = ts.tile_sort(torch.from_numpy(keys), torch.from_numpy(vals))
    want = tile_sort_pallas(jnp.asarray(keys), jnp.asarray(vals))
    for g, w in zip(got, want):
        P.assert_equal(g, w)


def test_padding_semantics():
    """A K that is no power of two pads with +inf keys and -1 values in
    the reference, and the padding never comes back: a real +inf key
    keeps its value, ahead of any padding."""
    keys = np.array([[3.0, np.inf, 1.0, 2.0, np.inf],
                     [0.5, -1.0, 7.0, np.inf, 2.0]], np.float32)
    vals = np.arange(10, dtype=np.int32).reshape(2, 5)
    got_k, got_v = ts.tile_sort(torch.from_numpy(keys),
                                torch.from_numpy(vals))
    assert tuple(got_k.shape) == (2, 5)
    assert got_v.tolist() == [[2, 3, 0, 1, 4], [6, 5, 9, 7, 8]]
    want = tile_sort_pallas(jnp.asarray(keys), jnp.asarray(vals))
    P.assert_equal(got_k, want[0])
    assert -1 not in np.asarray(want[1]).tolist()


def test_input_checks():
    k = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        ts.tile_sort(k, torch.zeros((2, 8)))           # values not int32
    with pytest.raises(ValueError):
        ts.tile_sort(k, torch.zeros((2, 4), dtype=torch.int32))
    assert tref.tile_sort_ref(k, torch.zeros((2, 8), dtype=torch.int32))[
        1].dtype == torch.int32


def _order_bits(keys):
    """The kernel's order_bits: uint32 whose order is the stable sort's
    order of float32 keys (-0 tied with +0, every NaN last)."""
    b = keys.view(np.uint32).astype(np.uint64)
    bits = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    bits = np.where(keys == 0, 0x80000000, bits)
    return np.where(np.isnan(keys), 0xFFFFFFFF, bits).astype(np.uint64)


def _run_schedule(keys, vals):
    """csrc/tile_sort.cu in numpy: (key bits << 32 | lane) items padded to
    the layout's n with items that sort last, every sweep of
    ``network_schedule`` as compare-exchanges between positions p and
    p ^ stride (the lower keeps the smaller item where p & span is 0),
    then the gather by lane. Each sweep's level must match the
    threads the kernel would move its items between."""
    t, k = keys.shape
    lay = ts.sort_layout(k)
    n, e = lay.n, lay.e
    pos = np.arange(n, dtype=np.uint64)
    x = np.empty((t, n), np.uint64)
    x[:, :k] = (_order_bits(keys) << np.uint64(32)) | pos[:k]
    x[:, k:] = (np.uint64(0xFFFFFFFF) << np.uint64(32)) | pos[k:]
    p = np.arange(n)
    for span, stride, level in ts.network_schedule(k):
        lo = p[(p & stride) == 0]
        hi = lo | stride
        thread_lo, thread_hi = lo // e, hi // e
        if level == "register":
            assert (thread_lo == thread_hi).all()
        elif level == "shuffle":
            assert (thread_lo != thread_hi).all()
            assert (thread_lo // 32 == thread_hi // 32).all()
        else:
            assert level == "shared" and (thread_lo // 32 != thread_hi // 32).all()
        # Each position takes its partner's item where (partner < own)
        # says so, as the kernel does for the distinct items it sorts.
        keep_min = ((p & span) == 0) == ((p & stride) == 0)
        y = x[:, p ^ stride]
        x = np.where((y < x) == keep_min, y, x)
    lanes = (x[:, :k] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return (np.take_along_axis(keys, lanes, axis=1),
            np.take_along_axis(vals, lanes, axis=1))


@pytest.mark.parametrize("k_pad", [1, 2, 16, 256, 1024, 4096])
def test_network_schedule_sorts_like_the_oracle(k_pad):
    for k in sorted({k_pad, k_pad * 3 // 4 + 1}):
        keys, vals = _rows(k_pad + k, 3, k, ties=True)
        specials = [np.nan, -0.0, 0.0, np.inf, -np.inf, 0.0, -0.0]
        flat = keys.reshape(-1)
        for i, v in enumerate(specials):
            flat[(i * 7919) % flat.size] = v
        # NaNs with payloads, one negative: the output keeps their bits.
        flat[(11 * 7919) % flat.size] = np.uint32(0x7FC00123).view(
            np.float32)
        flat[(13 * 7919) % flat.size] = np.uint32(0xFFC00042).view(
            np.float32)
        got_k, got_v = _run_schedule(keys, vals)
        want_k, want_v = jref.tile_sort_ref(jnp.asarray(keys),
                                            jnp.asarray(vals))
        np.testing.assert_array_equal(got_k.view(np.uint32),
                                      np.asarray(want_k).view(np.uint32))
        np.testing.assert_array_equal(got_v, np.asarray(want_v))
        port = tref.tile_sort_ref(torch.from_numpy(keys),
                                  torch.from_numpy(vals))
        np.testing.assert_array_equal(got_k.view(np.uint32),
                                      port[0].numpy().view(np.uint32))


@pytest.mark.parametrize("k_pad,levels", [
    (1, {"shuffle": 15}),
    (256, {"register": 21, "shuffle": 15}),
    (1024, {"register": 27, "shuffle": 25, "shared": 3}),
    (16384, {"register": 50, "shuffle": 40, "shared": 15}),
])
def test_network_schedule_levels(k_pad, levels):
    """All log2(n)(log2(n)+1)/2 sweeps, and at K = 1024 only 3 through
    shared memory (E = 8: strides >= 256)."""
    sched = ts.network_schedule(k_pad)
    n = ts.sort_layout(k_pad).n
    assert len(sched) == int(np.log2(n)) * (int(np.log2(n)) + 1) // 2
    counts = {}
    for _, _, level in sched:
        counts[level] = counts.get(level, 0) + 1
    assert counts == levels


def test_layout_fits_every_accepted_k():
    """Every K the wrapper accepts has a layout the kernel launches: a
    power-of-two row of >= K items, at most 1024 threads, E in {1, 2, 4,
    8, 16}, several rows a CTA only with one warp a row, and its shared
    memory within the card's; past K = 16384 the wrapper refuses."""
    for k in list(range(1, 300)) + [511, 512, 513, 1000, 1024, 4095, 4096,
                                    8192, 8193, 16383, 16384]:
        lay = ts.sort_layout(k)
        assert lay.n >= k and lay.n & (lay.n - 1) == 0
        assert lay.e in (1, 2, 4, 8, 16) and lay.n % lay.e == 0
        assert lay.threads == lay.n // lay.e * lay.rows_per_cta <= 1024
        assert lay.rows_per_cta == 1 or lay.n // lay.e == 32
        assert lay.smem <= MAX_SMEM
    for k in (16385, 40000):
        with pytest.raises(ValueError):
            ts.sort_layout(k)
