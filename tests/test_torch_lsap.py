"""The port's linear sum assignment (``stemseg_tpu_torch.inference.lsap``)
against scipy and the JAX package, indices compared exactly, ties included:

1. ``lsa_numpy`` equals ``scipy.optimize.linear_sum_assignment``;
2. the plain ``lsa_masked`` on a padded matrix with junk in its invalid
   slots equals scipy on the compacted matrix, in the original index space,
   and equals JAX's ``lsa_masked`` under the same masks;
3. empty sides and the association shapes (band x K) with partial masks.

The fuzz set is seeded with numpy: uniform costs, heavy integer ties,
0/1 matrices, quarters; tall, wide and square sides up to 12, padded by up
to 3 rows and columns. (The CUDA kernel is held against the plain version
and scipy on the card by ``chip_smoke.py`` phase 19.)
"""

import jax
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from stemseg_tpu.inference.lsap import lsa_masked as jax_lsa_masked
from stemseg_tpu_torch.inference.lsap import lsa_masked, lsa_numpy

torch.set_num_threads(2)


def _cases(seed, n_cases):
    rng = np.random.default_rng(seed)
    for _ in range(n_cases):
        nr = int(rng.integers(1, 13))
        nc = int(rng.integers(1, 13))
        kind = rng.integers(0, 4)
        if kind == 0:
            cost = rng.random((nr, nc))
        elif kind == 1:  # heavy ties: a tiny integer alphabet
            cost = rng.integers(0, 3, (nr, nc)).astype(np.float64)
        elif kind == 2:  # zeros and ones
            cost = np.zeros((nr, nc))
            cost[rng.random((nr, nc)) < 0.3] = 1.0
        else:  # quarters: ties at many magnitudes
            cost = np.round(rng.random((nr, nc)) * 4) / 4
        yield cost


def _padded(rng, cost):
    """``cost`` scattered into a larger matrix with 7.7 in the invalid
    slots, its row and column masks, and the kept indices."""
    nr, nc = cost.shape
    r_pad, c_pad = nr + int(rng.integers(0, 4)), nc + int(rng.integers(0, 4))
    rows = np.sort(rng.choice(r_pad, nr, replace=False))
    cols = np.sort(rng.choice(c_pad, nc, replace=False))
    row_valid, col_valid = np.zeros(r_pad, bool), np.zeros(c_pad, bool)
    row_valid[rows], col_valid[cols] = True, True
    full = np.full((r_pad, c_pad), 7.7, np.float32)
    full[np.ix_(rows, cols)] = cost
    return full, row_valid, col_valid, rows, cols


def _scipy_masked(full, row_valid, col_valid):
    rows, cols = np.where(row_valid)[0], np.where(col_valid)[0]
    c4r = np.full(len(row_valid), -1, np.int32)
    r4c = np.full(len(col_valid), -1, np.int32)
    if len(rows) and len(cols):
        for a, b in zip(*linear_sum_assignment(full[np.ix_(rows, cols)])):
            c4r[rows[a]], r4c[cols[b]] = cols[b], rows[a]
    return c4r, r4c


def _port(full, row_valid, col_valid):
    c4r, r4c = lsa_masked(torch.from_numpy(full), torch.from_numpy(row_valid),
                          torch.from_numpy(col_valid))
    assert c4r.dtype == r4c.dtype == torch.int32
    return c4r.numpy(), r4c.numpy()


def test_lsa_numpy_matches_scipy():
    for cost in _cases(0, 300):
        r_ref, c_ref = linear_sum_assignment(cost)
        r, c = lsa_numpy(cost)
        np.testing.assert_array_equal(r, r_ref)
        np.testing.assert_array_equal(c, c_ref)


@pytest.mark.parametrize("seed", [1, 2])
def test_lsa_masked_matches_scipy_compacted(seed):
    rng = np.random.default_rng(seed + 10)
    for i, cost in enumerate(_cases(seed, 150)):
        full, row_valid, col_valid, _, _ = _padded(rng, cost.astype(np.float32))
        want = _scipy_masked(full, row_valid, col_valid)
        got = _port(full, row_valid, col_valid)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"case {i}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"case {i}")


def test_lsa_masked_matches_jax():
    fn = jax.jit(jax_lsa_masked)
    rng = np.random.default_rng(5)
    for i, cost in enumerate(_cases(4, 60)):
        full, row_valid, col_valid, _, _ = _padded(rng, cost.astype(np.float32))
        want = [np.asarray(x) for x in jax.device_get(fn(full, row_valid, col_valid))]
        got = _port(full, row_valid, col_valid)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"case {i}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"case {i}")


@pytest.mark.parametrize("side", ["rows", "cols", "both"])
def test_lsa_masked_empty_sides(side):
    cost = np.zeros((4, 5), np.float32)
    row_valid = np.zeros(4, bool) if side in ("rows", "both") else np.ones(4, bool)
    col_valid = np.zeros(5, bool) if side in ("cols", "both") else np.ones(5, bool)
    c4r, r4c = _port(cost, row_valid, col_valid)
    assert (c4r == -1).all() and (r4c == -1).all()


@pytest.mark.parametrize("shape", [(20, 40), (40, 20), (80, 20), (10, 5)])
def test_lsa_masked_association_shapes(shape):
    """The association geometry (candidate band x K) with partial masks and
    IoU-like quarter costs, against scipy and JAX."""
    rng = np.random.default_rng(3)
    fn = jax.jit(jax_lsa_masked)
    for _ in range(15):
        cost = (rng.integers(0, 5, shape) / 4.0).astype(np.float32)
        row_valid = rng.random(shape[0]) < 0.6
        col_valid = rng.random(shape[1]) < 0.6
        got = _port(cost, row_valid, col_valid)
        for want in (_scipy_masked(cost, row_valid, col_valid),
                     [np.asarray(x) for x in jax.device_get(fn(cost, row_valid, col_valid))]):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
