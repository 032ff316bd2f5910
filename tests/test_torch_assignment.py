"""K3's plain version against the TPU auction kernel (interpret mode) and
the scipy oracle.

The plain version follows the TPU kernel round for round, so row_to_col
and col_to_row must be identical to it, ties included. Against scipy
(exact Hungarian with the same cost limit) the lapjv objective must
agree within 1e-2, the bound the JAX package's own auction tests use
for the eps slack, on problems of the kinds those tests use. (Under
dense contention the eps escalation leaves this auction, like the JAX
ones, further from the optimum; the oracle for it is the TPU kernel.)
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from strongsort_yolo_tpu.ops.pallas.auction_kernel import pallas_auction
from strongsort_yolo_tpu_torch.ops.assignment import (
    solve_assignment,
    solve_assignment_host,
)
from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import auction_plain


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kind, rng, r=16, c=12):
    cost = rng.uniform(0.0, 1.0, (r, c)).astype(np.float32)
    rv = np.ones(r, bool)
    cv = np.ones(c, bool)
    thresh = 0.8
    if kind == "masked":
        rv = rng.uniform(size=r) < 0.6
        cv = rng.uniform(size=c) < 0.7
        cost[~rv] = 1e4
        cost[:, ~cv] = 1e4
    elif kind == "empty":
        rv[:] = False
    elif kind == "ties":
        cost = np.round(cost * 4) / 4  # blocks of exactly equal costs
        thresh = 0.76
    elif kind == "tracker":  # IoU-like: a near-diagonal of good matches
        cost = np.ones((r, c), np.float32)
        n = min(r, c) - 3
        cost[np.arange(n), np.arange(n)] = rng.uniform(0.05, 0.4, n)
        cost[np.arange(n), (np.arange(n) + 1) % c] = rng.uniform(0.5, 0.9, n)
    elif kind == "sparse":  # few valid rows and columns among padding
        rv[4:] = False
        cv[5:] = False
    elif kind == "huge":  # unclipped magnitudes exercise the +-1e6 clip
        cost[0, 0] = 5e7
        cost[1, 1] = -3e7
        thresh = 0.5
    return cost, rv, cv, thresh


KINDS = ["random", "masked", "sparse", "empty", "ties", "tracker", "huge"]


def _pallas(cost, rv, cv, thresh):
    r2c, c2r = pallas_auction(
        jnp.asarray(cost), jnp.float32(thresh), jnp.asarray(rv),
        jnp.asarray(cv), interpret=True,
    )
    return np.asarray(r2c), np.asarray(c2r)


def _plain(cost, rv, cv, thresh):
    r2c, c2r = auction_plain(
        torch.from_numpy(cost)[None], torch.tensor([thresh], dtype=torch.float32),
        torch.from_numpy(rv)[None], torch.from_numpy(cv)[None],
    )
    return r2c[0].numpy(), c2r[0].numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_auction_identical_to_pallas(kind):
    cost, rv, cv, thresh = _problem(kind, np.random.default_rng(len(kind)))
    got, want = _plain(cost, rv, cv, thresh), _pallas(cost, rv, cv, thresh)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _objective(cost, r2c, thresh, rv, cv):
    """lapjv cost-limit objective: matched costs plus thresh / 2 for
    every valid row and column left unmatched."""
    rows = np.where(rv & (r2c >= 0))[0]
    n_free = rv.sum() + cv.sum() - 2 * len(rows)
    return cost[rows, r2c[rows]].sum() + n_free * thresh / 2.0


@pytest.mark.parametrize("kind", ["random", "sparse", "tracker"])
def test_objective_vs_scipy(kind):
    cost, rv, cv, thresh = _problem(kind, np.random.default_rng(10 + len(kind)))
    r2c, c2r = _plain(cost, rv, cv, thresh)
    for i in np.where(r2c >= 0)[0]:  # consistent, valid, within the limit
        assert c2r[r2c[i]] == i and rv[i] and cv[r2c[i]]
        assert cost[i, r2c[i]] <= thresh + 1e-6
    h_r2c, _ = solve_assignment_host(
        np.where(rv[:, None] & cv[None, :], cost, 1e6), thresh
    )
    np.testing.assert_allclose(
        _objective(cost, r2c, thresh, rv, cv),
        _objective(cost, h_r2c, thresh, rv, cv),
        atol=1e-2,
    )


def test_batched_solve_equals_single_problems():
    rng = np.random.default_rng(4)
    probs = [_problem(k, rng) for k in KINDS]
    cost = torch.from_numpy(np.stack([p[0] for p in probs]))
    rv = torch.from_numpy(np.stack([p[1] for p in probs]))
    cv = torch.from_numpy(np.stack([p[2] for p in probs]))
    th = torch.tensor([p[3] for p in probs], dtype=torch.float32)
    res = solve_assignment(cost, th, rv, cv)
    for i, p in enumerate(probs):
        r2c, c2r = _plain(*p)
        np.testing.assert_array_equal(res.row_to_col[i].numpy(), r2c)
        np.testing.assert_array_equal(res.col_to_row[i].numpy(), c2r)


@pytest.mark.parametrize("kind", ["random", "tracker"])
@pytest.mark.parametrize("shape", [(256, 256), (512, 250)])
def test_plain_auction_identical_to_pallas_at_crowd_sizes(kind, shape):
    """The association sizes of a crowded scene (tracker_max_dets 256 on
    256 slots, 250 detections on 512 slots), whose benefit block K3
    holds in its global-scratch form on the card."""
    r, c = shape
    cost, rv, cv, thresh = _problem(kind, np.random.default_rng(r + c), r, c)
    rv &= np.random.default_rng(r).uniform(size=r) < 0.7
    got, want = _plain(cost, rv, cv, thresh), _pallas(cost, rv, cv, thresh)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] >= 0).sum() > 0
