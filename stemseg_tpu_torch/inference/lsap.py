"""Linear sum assignment for the chainer's cross-window association: an
exact replica of ``scipy.optimize.linear_sum_assignment``.

The association (reference ``online_chainer.py``) accepts every Hungarian
pair whatever its IoU, so where several optimal assignments exist (a new
cluster with no overlap pixels ties with every track) the optimum scipy
returns decides the track labels. Moving the association onto the device
therefore replicates scipy's algorithm, shortest augmenting path (Crouse
2016, ``scipy/optimize/rectangular_lsap``), with its tie-breaking:

* ``remaining`` columns are visited in descending index order, with
  swap-remove compaction;
* among the minimum reduced costs the last unassigned column in
  ``remaining`` order wins, else the first one seen;
* a tall matrix (nr > nc) is solved transposed.

``lsa_numpy`` is the float64 host replica. ``lsa_masked`` (from
``ops.lsap``) works on a padded float32 matrix with row and column validity
masks and returns scipy's result on the compacted matrix, which is how the
streaming chainer feeds scipy (``chainer.fold_and_associate`` drops empty
rows and columns first): a CUDA kernel on the card, the plain PyTorch
version on the CPU. float32 and float64 can disagree only where two
assignments' total costs differ by less than float32's epsilon; exact ties
compare alike in both.
"""

from __future__ import annotations

import numpy as np

from stemseg_tpu_torch.ops.lsap import lsa_masked, lsa_masked_reference  # noqa: F401

__all__ = ["lsa_numpy", "lsa_masked", "lsa_masked_reference"]


def lsa_numpy(cost: np.ndarray):
    """Exact float64 replica of scipy's ``linear_sum_assignment`` (minimize).

    :param cost: [nr, nc] finite cost matrix
    :return: (row_ind, col_ind) — identical arrays to scipy's
    """
    cost = np.asarray(cost, dtype=np.float64)
    nr, nc = cost.shape
    if nr == 0 or nc == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    transpose = nc < nr
    if transpose:
        cost = cost.T.copy()
        nr, nc = nc, nr

    u = np.zeros(nr)
    v = np.zeros(nc)
    path = np.full(nc, -1, np.int64)
    col4row = np.full(nr, -1, np.int64)
    row4col = np.full(nc, -1, np.int64)

    for cur_row in range(nr):
        # ---- augmenting path from cur_row (scipy's augmenting_path) ----
        min_val = 0.0
        i = cur_row
        remaining = [nc - it - 1 for it in range(nc)]  # descending
        num_remaining = nc
        sr = np.zeros(nr, bool)
        sc = np.zeros(nc, bool)
        spc = np.full(nc, np.inf)
        sink = -1
        while sink == -1:
            index = -1
            lowest = np.inf
            sr[i] = True
            for it in range(num_remaining):
                j = remaining[it]
                r = min_val + cost[i, j] - u[i] - v[j]
                if r < spc[j]:
                    path[j] = i
                    spc[j] = r
                if spc[j] < lowest or (spc[j] == lowest and row4col[j] == -1):
                    lowest = spc[j]
                    index = it
            min_val = lowest
            if min_val == np.inf:
                raise ValueError("infeasible cost matrix")
            j = remaining[index]
            if row4col[j] == -1:
                sink = j
            else:
                i = row4col[j]
            sc[j] = True
            num_remaining -= 1
            remaining[index] = remaining[num_remaining]

        # ---- dual update ----
        u[cur_row] += min_val
        for i in range(nr):
            if sr[i] and i != cur_row:
                u[i] += min_val - spc[col4row[i]]
        for j in range(nc):
            if sc[j]:
                v[j] -= min_val - spc[j]

        # ---- augment ----
        j = sink
        while True:
            i = path[j]
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur_row:
                break

    if transpose:
        order = np.argsort(col4row)
        return col4row[order], order.astype(np.int64)
    return np.arange(nr, dtype=np.int64), col4row
