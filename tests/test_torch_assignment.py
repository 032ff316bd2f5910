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
from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import (
    EPS_REL,
    auction_plain,
    max_rounds_for,
)


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


# --- K3's round as the card runs it, emulated on the CPU ---------------

LANES = 32


def _k3_emulated(cost, rv, cv, thresh, lowest_row=True):
    """K3 (``csrc/auction.cu``) on one problem in numpy float32, round for
    round as the kernel runs it: the bidding rows compacted, each row's
    columns split over 32 lanes (lane l scans l, l + 32, ... with the
    serial rule), the lanes' top-2 merged by the kernel's five xor
    shuffle steps (the lower index wins among equal bests), and each
    column taking the largest packed key (the bid's order-preserving
    bits high, ~row low). -> (row_to_col, col_to_row) as auction_plain.
    ``lowest_row=False`` packs the row instead of ~row, a wrong tie rule
    for the mutation test."""
    f32 = np.float32
    r, c = cost.shape
    t = f32(thresh)
    cc = np.clip(cost.astype(f32), f32(-1e6), f32(1e6))
    valid = rv[:, None] & cv[None, :]
    cmin = min(t, cc[valid].min()) if valid.any() else t
    cmax = max(t, cc[valid].max()) if valid.any() else t
    crange = max(f32(cmax - cmin), f32(1e-6))
    w = np.where(valid, (t - cc) / crange, f32(-4.0)).astype(f32)
    price = np.zeros(c, f32)
    owner = np.full(c, -1, np.int64)
    owned = np.zeros(r, bool)
    sent = np.zeros(r, bool)
    eps = f32(EPS_REL)
    ncol = -(-c // LANES) * LANES
    lane = np.arange(LANES)
    rounds = 0
    while True:
        rows = np.flatnonzero(~sent & ~owned)
        if len(rows) == 0 or rounds >= max_rounds_for(r):
            break
        if rounds > 0 and rounds % 16 == 0:
            eps = f32(eps * f32(8.0))
        v = np.full((len(rows), ncol), -np.inf, f32)
        v[:, :c] = w[rows] - price
        v = v.reshape(len(rows), ncol // LANES, LANES)  # [:, k, l]: column 32 k + l
        k_best = v.argmax(1)  # the first maximum of each lane's columns
        bv = np.take_along_axis(v, k_best[:, None], 1)[:, 0]
        others = v.copy()
        np.put_along_axis(others, k_best[:, None], -np.inf, 1)
        sv = others.max(1)
        bj = np.where(lane < c, k_best * LANES + lane, np.iinfo(np.int32).max)
        for off in (1, 2, 4, 8, 16):
            obv, osv, obj = bv[:, lane ^ off], sv[:, lane ^ off], bj[:, lane ^ off]
            win = (obv > bv) | ((obv == bv) & (obj < bj))
            sv = np.where(win, np.where(bv > osv, bv, osv),
                          np.where(obv > sv, obv, sv))
            bv, bj = np.where(win, obv, bv), np.where(win, obj, bj)
        bv, sv, bj = bv[:, 0], sv[:, 0], bj[:, 0]
        retire = bv < 0
        sent[rows[retire]] = True
        place, bj = rows[~retire], bj[~retire]
        bid = ((w[place, bj] - np.maximum(sv[~retire], f32(0))) + eps).astype(f32)
        bid = np.where(bid == 0, f32(0), bid)  # +0 for either zero
        u = bid.view(np.uint32).astype(np.uint64)
        u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
        low = (~place if lowest_row else place).astype(np.uint64) & 0xFFFFFFFF
        keys = np.zeros(c, np.uint64)
        np.maximum.at(keys, bj, (u << np.uint64(32)) | low)
        for j in np.flatnonzero(keys):
            hi, lo = int(keys[j]) >> 32, int(keys[j]) & 0xFFFFFFFF
            win_row = (~lo & 0xFFFFFFFF) if lowest_row else lo
            if owner[j] >= 0:
                owned[owner[j]] = False
            owned[win_row], owner[j] = True, win_row
            bits = hi & 0x7FFFFFFF if hi & 0x80000000 else ~hi & 0xFFFFFFFF
            price[j] = np.array(bits, np.uint32).view(f32)
        rounds += 1
    limit = f32(t + f32(1e-6))
    r2c, c2r = np.full(r, -1, np.int32), np.full(c, -1, np.int32)
    for j, o in enumerate(owner):
        if o >= 0 and rv[o] and cv[j] and cc[o, j] <= limit:
            c2r[j], r2c[o] = o, j
    return r2c, c2r


def _assert_emulation_equals_plain(cost, rv, cv, thresh):
    got, want = _k3_emulated(cost, rv, cv, thresh), _plain(cost, rv, cv, thresh)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kind", KINDS + ["no_cols"])
def test_k3_round_emulation_equals_plain(kind):
    """The redesigned round, bit for bit against auction_plain on the
    cases above, and on a problem whose columns are all invalid."""
    cost, rv, cv, thresh = _problem(kind.replace("no_cols", "random"),
                                    np.random.default_rng(len(kind)))
    if kind == "no_cols":
        cv[:] = False
    _assert_emulation_equals_plain(cost, rv, cv, thresh)


@pytest.mark.parametrize("kind", ["random", "tracker", "ties"])
@pytest.mark.parametrize("shape", [(256, 128), (256, 256), (512, 250), (40, 5)])
def test_k3_round_emulation_equals_plain_at_tracker_sizes(kind, shape):
    """At the sizes the trackers give K3 (256 slots x 128 dets, the crowd
    sizes) with about half the rows valid, and with 5 columns (fewer
    than a warp's lanes)."""
    r, c = shape
    cost, rv, cv, thresh = _problem(kind, np.random.default_rng(r + c), r, c)
    rv &= np.random.default_rng(r).uniform(size=r) < 0.5
    _assert_emulation_equals_plain(cost, rv, cv, thresh)


def test_k3_round_emulation_equals_plain_on_the_crowd_scenes(monkeypatch):
    """Every assignment problem that the crowd scenes of
    tests/test_torch_crowding.py give the port's ByteTrack step (250
    objects on 512 slots, three frames)."""
    from strongsort_yolo_tpu_torch.track import bytetrack as tbt
    from strongsort_yolo_tpu_torch.track.state import init_track_state
    from test_torch_crowding import _crowd_frame

    calls, solve = [], tbt.solve_assignment

    def recording(cost, thresh, rv, cv):
        calls.append((cost.numpy()[0], float(thresh), rv.numpy()[0],
                      cv.numpy()[0]))
        return solve(cost, thresh, rv, cv)

    monkeypatch.setattr(tbt, "solve_assignment", recording)
    cfg = tbt.ByteTrackConfig(tracker_type="bytetrack", gmc_method="none")
    state = init_track_state(1, 512)
    for t in range(3):
        boxes, scores = _crowd_frame(t)
        state, _ = tbt.bytetrack_step(
            state, torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]),
            torch.zeros((1, 250), dtype=torch.int32),
            torch.ones((1, 250), dtype=torch.bool), cfg)
    assert len(calls) == 9 and any(rv.any() and cv.any()
                                   for _, _, rv, cv in calls)
    for cost, thresh, rv, cv in calls:
        _assert_emulation_equals_plain(cost, rv, cv, thresh)


def test_k3_emulation_tie_rule_is_seen():
    """Packing the row instead of ~row (the highest row winning among
    equal bids) changes the result on tied costs: the equality above is
    not blind to the tie rule."""
    cost, rv, cv, thresh = _problem("ties", np.random.default_rng(4), 64, 32)
    want = _plain(cost, rv, cv, thresh)
    got = _k3_emulated(cost, rv, cv, thresh, lowest_row=False)
    assert not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]))
