"""The reference's plain trackers on scenes whose answer is known by
hand, and its auction against the exact optimum where no two
assignments are close."""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from reference import assignment, tracker

F32 = np.float32


def scene(frames: int, speeds=((6.0, 2.0), (-4.0, 3.0))):
    """Two boxes moving at constant speeds, far apart."""
    starts = ((100.0, 100.0), (900.0, 500.0))
    for t in range(frames):
        yield np.array([[x + vx * t, y + vy * t, x + vx * t + 80, y + vy * t + 160]
                        for (x, y), (vx, vy) in zip(starts, speeds)], F32)


def run(step, cfg, frames, dets=scene, drop=()):
    st = tracker.Stream([])
    drawn = []
    for t, boxes in enumerate(dets(frames)):
        n = len(boxes)
        valid = np.array([(t, j) not in drop for j in range(n)])
        feats = np.eye(n, 8, dtype=F32)  # each object its own embedding
        drawn.append(dict(step(st, boxes, np.full(n, F32(0.9)), np.zeros(n, F32), valid,
                               feats, cfg, 256)))
    return st, drawn


def test_strongsort_confirms_at_n_init_and_keeps_ids():
    cfg = tracker.StrongSortConfig()
    st, drawn = run(tracker.strongsort_step, cfg, 8)
    # tentative for n_init - 1 frames, then both drawn under ids 1 and 2
    assert [sorted(d) for d in drawn[:cfg.n_init - 1]] == [[]] * (cfg.n_init - 1)
    assert all(sorted(d) == [1, 2] for d in drawn[cfg.n_init - 1:])
    last = list(scene(8))[-1]
    assert np.abs(drawn[-1][1] - last[0]).max() < 1.0
    assert st.next_id == 3


def test_strongsort_tentative_dies_at_first_miss_confirmed_survives():
    cfg = tracker.StrongSortConfig()
    st, drawn = run(tracker.strongsort_step, cfg, 8, drop={(1, 1), (5, 0)})
    # object 1 missed on frame 1 while tentative: its track died and a new
    # one (id 3) took it from frame 2; object 0 missed on frame 5 while
    # confirmed: not drawn then, back under id 1 after
    assert 2 not in drawn[-1] and 3 in drawn[-1]
    assert 1 not in drawn[5] and 1 in drawn[6]


def test_botsort_lost_then_found_and_births():
    cfg = tracker.ByteTrackConfig()
    st, drawn = run(tracker.bytetrack_step, cfg, 8, drop={(4, 0)})
    # activated on the first frame, ids in detection order
    assert sorted(drawn[0]) == [1, 2]
    assert 1 not in drawn[4] and [t.status for t in st.tracks if t.id == 1] == [tracker.TRACKED]
    assert sorted(drawn[-1]) == [1, 2]


def test_botsort_warp_moves_tracks():
    cfg = tracker.ByteTrackConfig(gmc_method="flow_tpu")
    st = tracker.Stream([])
    boxes = next(scene(1))
    n = len(boxes)
    args = (np.full(n, F32(0.9)), np.zeros(n, F32), np.ones(n, bool), None, cfg, 256)
    tracker.bytetrack_step(st, boxes, *args)
    shift = np.array([[1, 0, 30], [0, 1, -20]], F32)
    drawn = dict(tracker.bytetrack_step(st, boxes + F32([30, -20, 30, -20]), *args,
                                        warp=shift))
    assert np.abs(drawn[1] - (boxes[0] + [30, -20, 30, -20])).max() < 1e-3


@pytest.mark.parametrize("seed", range(5))
def test_auction_is_exact_where_no_assignment_is_close(seed):
    rng = np.random.default_rng(seed)
    r, c = 12, 20
    cost = rng.permutation(r * c).reshape(r, c).astype(F32) / (r * c)  # gaps of 1/240
    thresh = 2.0  # every pair allowed: the auction finds a full matching
    got = assignment.solve(cost, thresh)
    rows, cols = linear_sum_assignment(cost)
    want = dict(zip(rows.tolist(), cols.tolist()))

    def total(m):
        return sum(float(cost[i, j]) for i, j in m.items())

    assert len(got) == r
    # the auction is optimal within r * eps of the cost range
    assert total(got) <= total(want) + r * float(assignment.EPS_REL) * 2.0 + 1e-6


def test_auction_leaves_pairs_past_the_limit():
    cost = np.array([[0.1, 0.9], [0.95, 0.99]], F32)
    assert assignment.solve(cost, 0.5) == {0: 0}
