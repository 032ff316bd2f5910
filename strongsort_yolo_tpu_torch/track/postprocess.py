"""Offline track post-processing: the StrongSORT++ extras, GSI
(Gaussian-smoothed interpolation) and tracklet linking.

Counterpart of ``strongsort_yolo_tpu/track/postprocess.py``, host numpy
as there. Operates on completed per-frame track records (the label-file
format of utils/labels.py, or in-memory lists), so it is an offline
tool, not part of the per-frame step.

- ``gsi``: per track, linearly fill detection gaps up to
  ``max_gap`` frames, then smooth each box coordinate with Gaussian-
  process regression (RBF kernel over frame index).
- ``link_tracklets``: AFLink-style global trajectory linking, scored by
  a pluggable per-pair ``scorer`` (default: a motion-consistency cost,
  constant-velocity extrapolation gap + direction agreement) or a
  whole-matrix ``cost_fn`` (the learned AFLink net,
  ``track/aflink.make_cost_fn``), solved globally by the host Hungarian
  ``ops/assignment.solve_assignment_host``, as the JAX package solves it.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from strongsort_yolo_tpu_torch.ops.assignment import solve_assignment_host


def records_to_tracks(records):
    """records: iterable of (frame, tid, x1, y1, x2, y2[, conf]).
    -> {tid: sorted array (n, 5+) of [frame, x1, y1, x2, y2, ...]}."""
    tracks = defaultdict(list)
    for rec in records:
        tracks[int(rec[1])].append([rec[0], *rec[2:]])
    return {
        tid: np.asarray(sorted(rows, key=lambda r: r[0]), float)
        for tid, rows in tracks.items()
    }


def _rbf_smooth(t, y, tau: float):
    """1-D GP regression with RBF kernel (noise-regularized)."""
    t = t[:, None]
    d2 = (t - t.T) ** 2
    k = np.exp(-d2 / (2.0 * tau * tau))
    alpha = np.linalg.solve(k + 1e-2 * np.eye(len(t)), y)
    return k @ alpha


def gsi(
    tracks: dict[int, np.ndarray],
    *,
    max_gap: int = 20,
    tau: float = 10.0,
) -> dict[int, np.ndarray]:
    """Gap interpolation + Gaussian smoothing per track."""
    out = {}
    for tid, rows in tracks.items():
        frames = rows[:, 0].astype(int)
        # linear interpolation over gaps <= max_gap
        filled = [rows[0]]
        for prev, cur in zip(rows[:-1], rows[1:]):
            gap = int(cur[0] - prev[0])
            if 1 < gap <= max_gap:
                for g in range(1, gap):
                    w = g / gap
                    filled.append(prev * (1 - w) + cur * w)
            filled.append(cur)
        arr = np.asarray(filled)
        if len(arr) >= 4:
            t = arr[:, 0]
            smoothed = arr.copy()
            for c in range(1, 5):
                smoothed[:, c] = _rbf_smooth(t, arr[:, c], tau)
            arr = smoothed
        out[tid] = arr
    return out


def _default_link_score(a: np.ndarray, b: np.ndarray) -> float:
    """Motion-consistency cost for linking tracklet a (earlier) to b
    (later); lower = better, >=1 means implausible."""
    ta_end, tb_start = a[-1, 0], b[0, 0]
    gap = tb_start - ta_end
    if gap <= 0 or gap > 30:
        return 10.0
    ca = (a[-1, 1:3] + a[-1, 3:5]) / 2.0
    cb = (b[0, 1:3] + b[0, 3:5]) / 2.0
    # velocity from the tail of a (up to 5 points)
    tail = a[-min(len(a), 5) :]
    if len(tail) >= 2 and tail[-1, 0] > tail[0, 0]:
        v = (
            (tail[-1, 1:3] + tail[-1, 3:5]) / 2.0
            - (tail[0, 1:3] + tail[0, 3:5]) / 2.0
        ) / (tail[-1, 0] - tail[0, 0])
    else:
        v = np.zeros(2)
    pred = ca + v * gap
    size = max(
        a[-1, 3] - a[-1, 1], a[-1, 4] - a[-1, 2],
        b[0, 3] - b[0, 1], b[0, 4] - b[0, 2], 1.0,
    )
    miss = np.linalg.norm(pred - cb) / size
    return float(miss + 0.02 * gap)


def link_tracklets(
    tracks: dict[int, np.ndarray],
    *,
    scorer=None,
    cost_fn=None,
    link_thresh: float = 0.8,
) -> dict[int, np.ndarray]:
    """Globally link tracklet pairs (end -> start) below the score
    threshold; merged tracklets keep the earlier id.

    scorer: per-pair callable (a, b) -> cost. cost_fn: whole-matrix
    callable (list of tracklets in id order) -> (n, n) costs — the
    learned AFLink path (track/aflink.make_cost_fn) scores every pair
    in one batched forward this way."""
    ids = sorted(tracks)
    n = len(ids)
    if n < 2:
        return dict(tracks)
    if cost_fn is not None:
        cost = np.asarray(cost_fn([tracks[t] for t in ids]), float)
    else:
        scorer = scorer or _default_link_score
        cost = np.full((n, n), 10.0)
        for i, a in enumerate(ids):
            for j, b in enumerate(ids):
                if a == b:
                    continue
                cost[i, j] = scorer(tracks[a], tracks[b])
    r2c, _ = solve_assignment_host(cost, link_thresh)

    parent = {tid: tid for tid in ids}

    def root(t):
        while parent[t] != t:
            t = parent[t]
        return t

    # merge chains: i's successor is j
    for i, j in enumerate(r2c):
        if j >= 0:
            parent[ids[j]] = root(ids[i])
    merged = defaultdict(list)
    for tid in ids:
        merged[root(tid)].append(tracks[tid])
    return {
        tid: np.concatenate(sorted(parts, key=lambda p: p[0, 0]))
        for tid, parts in merged.items()
    }


def strongsort_pp(
    records,
    *,
    link: bool = True,
    smooth: bool = True,
    max_gap: int = 20,
    tau: float = 10.0,
    link_thresh: float = 0.8,
    aflink: bool | str = False,
    device: torch.device | str = "cuda",
):
    """Full offline pass: records -> linked+smoothed records.

    aflink: use the learned link classifier (track/aflink.py) instead
    of the motion heuristic — True loads the shipped
    ``assets/aflink_synth.npz``, a string loads that checkpoint path;
    its forward runs on ``device``.
    """
    tracks = records_to_tracks(records)
    if link:
        cost_fn = None
        if aflink:
            from strongsort_yolo_tpu_torch.track import aflink as _af

            path = aflink if isinstance(aflink, str) else _af.default_checkpoint()
            cost_fn = _af.make_cost_fn(_af.load_aflink(path, device))
        tracks = link_tracklets(
            tracks, cost_fn=cost_fn, link_thresh=link_thresh
        )
    if smooth:
        tracks = gsi(tracks, max_gap=max_gap, tau=tau)
    out = []
    for tid, rows in tracks.items():
        for r in rows:
            out.append((int(round(r[0])), tid, *r[1:]))
    out.sort(key=lambda r: (r[0], r[1]))
    return out
