"""The lane-contribution reduction of ``csrc/blend.cuh``, modelled in
numpy on the CPU.

A warp's 32 pixel threads each hold the weights of 32 consecutive lanes.
The kernel reduces them with the xor butterfly transposed: at the step
for thread bit h (16, 8, 4, 2, 1) a thread keeps the lanes whose bit h
equals its own and adds its partner's values for them, so thread t ends
with lane t's sum. The per-lane xor butterfly (``v += shfl_xor(v, off)``
for off = 16 ... 1, read from thread 0) sums the same tree, and float
addition is commutative, so the two give the same float32 bits: that is
what keeps ``lane_contrib`` bit-identical to the kernel it replaced. The
kernel itself runs only on the card (chip_smoke.py phase 2c)."""
import numpy as np
import pytest

THREADS = np.arange(32)


def xor_butterfly(w):
    """(32 threads, 32 lanes) float32 -> per-lane sums as thread 0 holds
    them after the per-lane butterfly."""
    out = np.empty(32, np.float32)
    for lane in range(32):
        v = w[:, lane].copy()
        for off in (16, 8, 4, 2, 1):
            v = v + v[THREADS ^ off]          # own + partner, float32
        out[lane] = v[0]
    return out


def transposed_butterfly(w):
    """blend.cuh::transposed_sum32 on 32 threads: returns what thread t
    holds at the end, for t = 0..31."""
    vals = w.copy()                           # vals[t, i]: thread t's w[i]
    for h in (16, 8, 4, 2, 1):
        upper = (THREADS & h) != 0
        lower_half, upper_half = vals[:, :h], vals[:, h:2 * h]
        send = np.where(upper[:, None], lower_half, upper_half)
        keep = np.where(upper[:, None], upper_half, lower_half)
        vals = keep + send[THREADS ^ h]       # own + partner's, float32
    return vals[:, 0]


def weights(seed):
    """Weights of mixed magnitude (1e-9 .. 1e2) with many exact zeros,
    whole zero lanes and whole zero threads, as the blend produces."""
    rng = np.random.default_rng(seed)
    w = (rng.random((32, 32)) * 10.0 ** rng.integers(-9, 3, (32, 32)))
    w[rng.random((32, 32)) < 0.4] = 0.0
    w[:, rng.integers(0, 32, 4)] = 0.0
    w[rng.integers(0, 32, 3), :] = 0.0
    return w.astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_transposed_reduction_matches_xor_butterfly_bit_for_bit(seed):
    w = weights(seed)
    got = transposed_butterfly(w)
    want = xor_butterfly(w)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_reduction_order_is_not_trivially_exact():
    """The check above has teeth: a sequential sum over the threads
    (another tree) differs in the last bits for these weights."""
    w = weights(0)
    seq = np.zeros(32, np.float32)
    for t in range(32):
        seq = seq + w[t]
    assert not np.array_equal(seq.view(np.uint32),
                              xor_butterfly(w).view(np.uint32))


def test_all_zero_warp_stores_zero():
    """A warp whose weights are all 0 skips the shuffles and stores +0,
    as the sums of +0 would."""
    w = np.zeros((32, 32), np.float32)
    assert transposed_butterfly(w).view(np.uint32).tolist() == [0] * 32
