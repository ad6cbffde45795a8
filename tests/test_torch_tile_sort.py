"""The tile sorter's plain version against the JAX reference on the CPU:
``tile_sort_ref`` on rows with ties (exact: both are stable sorts), and
``tile_sort_pallas`` in interpret mode on distinct keys at the reference
suite's small (4, 16) cases (its network is not stable on ties). The
kernel itself is held to the plain version on the card by phase 2d of
chip_smoke.py (ties, -0, NaN, odd K, K = 1 and a key frame's rows)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.kernels import ref as jref
from repro.kernels.tile_sort import tile_sort_pallas
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tile_sort as ts


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
    got = ts.tile_sort(torch.from_numpy(keys), torch.from_numpy(vals))
    want = jref.tile_sort_ref(jnp.asarray(keys), jnp.asarray(vals))
    for g, w in zip(got, want):
        P.assert_equal(g, w)
    assert ts.tile_sort.launches == 0          # CPU: the plain version


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
