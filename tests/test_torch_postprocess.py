"""The port's offline post-processing (track/postprocess.py: GSI and
tracklet linking, the StrongSORT++ pass) and its MOT metrics
(utils/metrics.py) against the JAX package's functions.

Both are host numpy in both packages and the port keeps the JAX code, so
every output must be equal exactly: track arrays ``np.array_equal``,
records and metric dicts ``==``. Inputs: seeded random records (tracks
with jitter, dropouts and id splits, several objects) and the split and
divergent tracks of tests/test_postprocess.py.
"""

import numpy as np
import pytest

from strongsort_yolo_tpu.track import postprocess as jpp
from strongsort_yolo_tpu.utils import metrics as jmetrics
from strongsort_yolo_tpu_torch.track import postprocess as tpp
from strongsort_yolo_tpu_torch.utils import metrics as tmetrics
from test_postprocess import make_records


def random_records(seed: int, n_objects: int = 6, frames: int = 120):
    """Objects moving at constant velocity with box jitter, dropped
    detections, and tracks split into a new id after a gap of 2-25
    frames (links for the linker, holes for GSI)."""
    rng = np.random.default_rng(seed)
    recs, next_id = [], 1
    for _ in range(n_objects):
        t0 = int(rng.integers(0, frames // 3))
        t1 = int(rng.integers(t0 + 20, frames))
        x, y = rng.uniform(0, 1500), rng.uniform(0, 800)
        vx, vy = rng.normal(0, 4, 2)
        w, h = rng.uniform(30, 90), rng.uniform(60, 180)
        tid, t = next_id, t0
        next_id += 1
        while t < t1:
            if rng.uniform() < 0.04:  # split: a gap, then a new id
                t += int(rng.integers(2, 26))
                tid, next_id = next_id, next_id + 1
                continue
            if rng.uniform() > 0.1:  # dropout otherwise
                cx = x + vx * t + rng.normal(0, 2)
                cy = y + vy * t + rng.normal(0, 2)
                recs.append((t, tid, cx, cy, cx + w, cy + h))
            t += 1
    return recs


def split_records():
    recs = make_records(1, 0, 20) + make_records(2, 26, 46, x0=100.0 + 5.0 * 26)
    return recs + [(t, 3, 800.0, 400.0, 840.0, 480.0) for t in range(0, 46)]


def divergent_records():
    return make_records(1, 0, 20, v=5.0) + make_records(2, 26, 46, x0=900.0,
                                                        v=-5.0)


CASES = {f"random{s}": (lambda s=s: random_records(s)) for s in range(4)}
CASES["split"] = split_records
CASES["divergent"] = divergent_records
CASES["gaps"] = lambda: make_records(1, 0, 20, skip={7, 8, 9})


def assert_tracks_equal(want: dict, got: dict):
    assert list(want) == list(got)
    for tid in want:
        assert np.array_equal(want[tid], got[tid]), tid


def gap_cost_fn(tracks_list):
    """A whole-matrix cost: the frame gap over 30, implausible (10) unless
    the second tracklet starts after the first ends."""
    n = len(tracks_list)
    cost = np.full((n, n), 10.0)
    for i, a in enumerate(tracks_list):
        for j, b in enumerate(tracks_list):
            gap = b[0, 0] - a[-1, 0]
            if i != j and gap > 0:
                cost[i, j] = gap / 30.0
    return cost


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_to_tracks_and_gsi_equal_jax(case):
    recs = CASES[case]()
    want, got = jpp.records_to_tracks(recs), tpp.records_to_tracks(recs)
    assert_tracks_equal(want, got)
    for kw in ({}, {"max_gap": 5, "tau": 3.0}):
        assert_tracks_equal(jpp.gsi(want, **kw), tpp.gsi(got, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_link_tracklets_equal_jax(case):
    tracks = jpp.records_to_tracks(CASES[case]())
    assert_tracks_equal(jpp.link_tracklets(tracks),
                        tpp.link_tracklets(tracks))
    assert_tracks_equal(
        jpp.link_tracklets(tracks, cost_fn=gap_cost_fn, link_thresh=0.5),
        tpp.link_tracklets(tracks, cost_fn=gap_cost_fn, link_thresh=0.5))
    for a in tracks.values():
        for b in tracks.values():
            assert jpp._default_link_score(a, b) == tpp._default_link_score(a, b)


def test_link_merges_split_and_keeps_divergent():
    """The bars of tests/test_postprocess.py through the port."""
    linked = tpp.link_tracklets(tpp.records_to_tracks(split_records()))
    assert set(linked) == {1, 3} and len(linked[1]) == 40
    linked = tpp.link_tracklets(tpp.records_to_tracks(divergent_records()))
    assert set(linked) == {1, 2}


@pytest.mark.parametrize("case", sorted(CASES))
def test_strongsort_pp_equals_jax(case):
    recs = CASES[case]()
    for kw in ({}, {"link": False}, {"smooth": False}, {"link_thresh": 0.3}):
        assert jpp.strongsort_pp(recs, **kw) == tpp.strongsort_pp(recs, **kw)


def random_frames(rng, n_frames: int, ids: int, swap_every: int):
    gt, hyp = [], []
    for t in range(n_frames):
        g, h = [], []
        for k in range(1, ids + 1):
            x, y = 50.0 * k + 2.0 * t, 30.0 * k
            box = (x, y, x + 40.0, y + 80.0)
            g.append((k, *box))
            if rng.uniform() < 0.9:  # a miss otherwise
                hid = k + 100 * ((t // swap_every) % 2 if k < 3 else 0)
                h.append((hid, *(v + rng.normal(0, 6.0) for v in box)))
        if rng.uniform() < 0.2:  # a false positive
            h.append((999, 900.0, 500.0, 940.0, 580.0))
        gt.append(g)
        hyp.append(h)
    return gt, hyp


@pytest.mark.parametrize("seed", range(3))
def test_evaluate_mot_equals_jax(seed):
    gt, hyp = random_frames(np.random.default_rng(seed), 60, 5, 7 + seed)
    for thresh in (0.5, 0.3):
        want = jmetrics.evaluate_mot(gt, hyp, iou_thresh=thresh)
        got = tmetrics.evaluate_mot(gt, hyp, iou_thresh=thresh)
        assert want == got
        assert got["idsw"] > 0 and got["fp"] > 0 and got["fn"] > 0
    a = np.asarray([g[1:] for g in gt[0]])
    assert np.array_equal(jmetrics._iou_matrix(a, a[::-1]),
                          tmetrics._iou_matrix(a, a[::-1]))


def test_load_mot_labels_equals_jax(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text(
        "0 0 1 0.9 10 20 50 90 -1 -1 -1 -1\n"
        "0 2 4 0.5 110 120 150 190 -1 -1 -1 -1\n"
        "short line\n"
        "3 0 1 0.8 12.5 21 52 91.25 -1 -1 -1 -1\n")
    want = jmetrics.load_mot_labels(str(path))
    assert tmetrics.load_mot_labels(str(path)) == want
    assert len(want) == 4 and want[1] == [] and len(want[0]) == 2
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert tmetrics.load_mot_labels(str(empty)) == [] == \
        jmetrics.load_mot_labels(str(empty))
