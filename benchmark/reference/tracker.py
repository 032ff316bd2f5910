"""The trackers, plain: one stream at a time, a list of tracks, a loop
over them, NumPy in the precision of the arrays given (the tracker's
float32, as the configuration states it).

Written from the papers and the system's published settings, with the
JAX package's ``track/`` modules as the pattern for the choices the
papers leave open (taken as a pattern and rewritten; nothing imported):

- the Kalman filter of DeepSORT (Wojke et al., arXiv:1703.07402):
  constant velocity over (cx, cy, a, h) for StrongSORT, over (cx, cy,
  w, h) for BoT-SORT (Aharon et al., arXiv:2206.14651); noise weights
  1/20 for position and 1/160 for velocity; StrongSORT's NSA noise, the
  measurement noise times (1 - confidence) (Du et al., arXiv:2202.13514);
- StrongSORT: an EMA appearance bank, one assignment over confirmed
  tracks on lambda * cosine / 2 + (1 - lambda) * Mahalanobis / gate with
  the chi-square and cosine gates and no matching cascade, an IoU
  fallback for tentative tracks and for confirmed ones that matched on
  the frame before, tentative tracks dying at their first miss,
  confirmed ones after ``max_age`` missed frames;
- ByteTrack (Zhang et al., arXiv:2110.06864) with BoT-SORT's camera
  motion: high detections against tracked and lost tracks (IoU fused
  with the score), low detections against the tracked ones left, the
  unconfirmed against the high ones left, births above
  ``new_track_thresh``, lost tracks dropped after ``track_buffer``
  frames; the warp applied to every track, BoT-SORT's ``multi_gmc``;
- every assignment the auction the system defines (``assignment``).

A stream holds at most ``slots`` tracks; births past that are dropped,
in detection order, as are the system's. A new track takes the next id.
Tracks are compared by id, so where the system keeps a track does not
matter here."""

from __future__ import annotations

import dataclasses

import numpy as np

from reference.assignment import solve

TRACKED, LOST = 1, 2
CHI2_95_4DOF = 9.4877
INF_COST = 1.0e4  # a forbidden pair
STD_POS, STD_VEL = 1.0 / 20, 1.0 / 160


@dataclasses.dataclass
class Track:
    id: int
    status: int  # TRACKED or LOST
    activated: bool  # ByteTrack's is_activated; StrongSORT's confirmed
    mean: np.ndarray  # (8,)
    cov: np.ndarray  # (8, 8)
    score: float
    cls: int
    feat: np.ndarray  # (D,) EMA of unit embeddings
    end_frame: int  # frame of its last update
    hits: int


@dataclasses.dataclass
class Stream:
    tracks: list[Track]
    next_id: int = 1
    frame_id: int = 0


@dataclasses.dataclass(frozen=True)
class StrongSortConfig:
    det_thresh: float = 0.3
    max_cosine_distance: float = 0.45
    lambda_appearance: float = 0.98
    match_thresh: float = 0.45
    max_iou_distance: float = 0.7
    max_age: int = 30
    n_init: int = 3
    ema_alpha: float = 0.9
    gmc_method: str = "none"
    form: str = "xyah"


@dataclasses.dataclass(frozen=True)
class ByteTrackConfig:
    tracker_type: str = "botsort"
    track_high_thresh: float = 0.25
    track_low_thresh: float = 0.1
    new_track_thresh: float = 0.25
    track_buffer: int = 30
    match_thresh: float = 0.8
    fuse_score: bool = True
    gmc_method: str = "none"
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.25
    with_reid: bool = False
    second_match_thresh: float = 0.5
    unconfirmed_match_thresh: float = 0.7

    @property
    def form(self) -> str:
        return "xywh" if self.tracker_type == "botsort" else "xyah"


# -- boxes ------------------------------------------------------------------

def to_meas(b, form):
    """xyxy -> (cx, cy, w, h) or (cx, cy, w / h, h)."""
    x1, y1, x2, y2 = b
    w, h = x2 - x1, y2 - y1
    third = w if form == "xywh" else w / max(h, 1e-6)
    return np.array([(x1 + x2) / 2, (y1 + y2) / 2, third, h], b.dtype)


def to_xyxy(m, form):
    cx, cy, third, h = m[:4]
    w = third if form == "xywh" else third * h
    return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], m.dtype)


def iou(a, b):
    """IoU of box ``a`` with each row of ``b`` (M, 4)."""
    iw = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0)
    ih = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0)
    inter = iw * ih
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter
    return inter / (union + np.asarray(1e-7, b.dtype))


# -- the Kalman filter -------------------------------------------------------

def _std(m4, form, weight, const):
    """Noise scales of the four measured components: by w and h in the
    xywh form; by h in xyah, the aspect a constant."""
    if form == "xywh":
        w, h = m4[2], m4[3]
        return np.array([weight * w, weight * h, weight * w, weight * h], m4.dtype)
    h = m4[3]
    return np.array([weight * h, weight * h, const, weight * h], m4.dtype)


def kf_initiate(z, form):
    mean = np.concatenate([z, np.zeros(4, z.dtype)])
    std = np.concatenate([2 * _std(z, form, STD_POS, 1e-2),
                          10 * _std(z, form, STD_VEL, 1e-5)])
    return mean, np.diag(std ** 2)


F = np.eye(8)
F[:4, 4:] = np.eye(4)


def kf_predict(mean, cov, form):
    q = np.concatenate([_std(mean, form, STD_POS, 1e-2),
                        _std(mean, form, STD_VEL, 1e-5)]) ** 2
    f = F.astype(mean.dtype)
    return f @ mean, f @ cov @ f.T + np.diag(q)


def kf_project(mean, cov, form, conf=None):
    std = _std(mean, form, STD_POS, 1e-2)
    if form == "xyah":
        std[2] = 1e-1
    r = np.maximum(std ** 2, 1e-9)
    if conf is not None:  # NSA
        r = np.maximum(r * min(max(1.0 - conf, 0.0), 1.0), 1e-9)
    return mean[:4], cov[:4, :4] + np.diag(r)


def kf_update(mean, cov, z, form, conf=None):
    hx, s = kf_project(mean, cov, form, conf)
    gain = np.linalg.solve(s, cov[:, :4].T).T  # P H^T S^-1
    return mean + gain @ (z - hx), cov - gain @ s @ gain.T


def mahalanobis(mean, cov, zs, form):
    """Squared Mahalanobis distance of each measurement row to the track."""
    hx, s = kf_project(mean, cov, form)
    d = zs - hx
    return np.einsum("ni,ni->n", d, np.linalg.solve(s, d.T).T)


def warp_track(t: Track, warp, form):
    r, tr = warp[:, :2], warp[:, 2]
    if form == "xywh":  # every (x, y) pair of the state turns; the centre moves
        r8 = np.kron(np.eye(4, dtype=r.dtype), r)
        t.mean = r8 @ t.mean
        t.mean[:2] += tr
    else:  # the centre alone
        r8 = np.eye(8, dtype=r.dtype)
        r8[:2, :2] = r
        t.mean = t.mean.copy()
        t.mean[:2] = r @ t.mean[:2] + tr
    t.cov = r8 @ t.cov @ r8.T


def unit(v):
    return v / max(np.linalg.norm(v), 1e-12)


def _match(rows, cols, cost_row, thresh, slots):
    """Assign ``rows`` (tracks) to ``cols`` (detection indices) by the
    auction on ``cost_row(track, cols)``, a track's costs over the
    detections. -> {track index: detection}."""
    if not rows or not cols:
        return {}
    cols_a = np.asarray(cols)
    cost = np.stack([cost_row(i, cols_a) for i in rows])
    got = solve(cost, thresh, slots)
    return {rows[i]: cols[j] for i, j in got.items()}


# -- StrongSORT --------------------------------------------------------------

def strongsort_step(st: Stream, boxes, scores, classes, valid, feats, cfg, slots,
                    warp=None):
    """One frame of one stream. ``boxes`` (N, 4) xyxy, ``feats`` (N, D)
    unit embeddings. -> the rows drawn: [(id, xyxy box)]."""
    form = cfg.form
    st.frame_id += 1
    n = len(scores)
    usable = [j for j in range(n) if valid[j] and scores[j] >= cfg.det_thresh]
    z = {j: to_meas(boxes[j], form) for j in usable}
    tracks = st.tracks
    for t in tracks:  # every live track is TRACKED in StrongSORT
        t.mean, t.cov = kf_predict(t.mean, t.cov, form)
        if warp is not None:
            warp_track(t, warp, form)

    confirmed = [i for i, t in enumerate(tracks) if t.activated]
    zs = np.array([z[j] for j in usable]).reshape(-1, 4)
    at = {j: u for u, j in enumerate(usable)}

    def blended(i, cols):
        t = tracks[i]
        emb = np.clip(1 - feats[cols] @ t.feat, 0, 2)
        d = mahalanobis(t.mean, t.cov, zs[[at[j] for j in cols]], form)
        cost = (cfg.lambda_appearance * (emb / 2)
                + (1 - cfg.lambda_appearance) * (d / CHI2_95_4DOF))
        return np.where((d > CHI2_95_4DOF) | (emb / 2 > cfg.max_cosine_distance),
                        INF_COST, cost)

    m1 = _match(confirmed, usable, blended, cfg.match_thresh, slots)
    fallback = [i for i, t in enumerate(tracks)
                if not t.activated or (i not in m1 and t.end_frame == st.frame_id - 1)]
    left = [j for j in usable if j not in m1.values()]
    m2 = _match(fallback, left,
                lambda i, cols: 1 - iou(to_xyxy(tracks[i].mean, form), boxes[cols]),
                cfg.max_iou_distance, slots)
    matched = {**m1, **m2}

    for i, j in matched.items():
        t = tracks[i]
        t.mean, t.cov = kf_update(t.mean, t.cov, z[j], form, conf=scores[j])
        t.hits += 1
        t.activated = t.activated or t.hits >= cfg.n_init
        mixed = (cfg.ema_alpha * t.feat + (1 - cfg.ema_alpha) * feats[j]
                 if np.abs(t.feat).sum() > 1e-8 else feats[j])
        t.feat = unit(mixed)
        t.score, t.cls, t.end_frame = float(scores[j]), int(classes[j]), st.frame_id

    st.tracks = [t for i, t in enumerate(tracks)
                 if i in matched or (t.activated and st.frame_id - t.end_frame <= cfg.max_age)]
    taken = set(matched.values())
    for j in usable:
        if j in taken:
            continue
        if len(st.tracks) < slots:
            mean, cov = kf_initiate(z[j], form)
            st.tracks.append(Track(st.next_id, TRACKED, cfg.n_init <= 1, mean, cov,
                                   float(scores[j]), int(classes[j]), unit(feats[j]),
                                   st.frame_id, 1))
            st.next_id += 1
    return [(t.id, to_xyxy(t.mean, form)) for t in st.tracks
            if t.activated and t.end_frame == st.frame_id]


# -- ByteTrack / BoT-SORT ----------------------------------------------------

def bytetrack_step(st: Stream, boxes, scores, classes, valid, feats, cfg, slots,
                   warp=None):
    """One frame of one stream (appearance unused: ``with_reid`` off).
    -> the rows drawn: [(id, xyxy box)]."""
    form = cfg.form
    st.frame_id += 1
    n = len(scores)
    high = [j for j in range(n) if valid[j] and scores[j] >= cfg.track_high_thresh]
    low = [j for j in range(n) if valid[j]
           and cfg.track_low_thresh <= scores[j] < cfg.track_high_thresh]
    tracks = st.tracks
    for t in tracks:
        if t.status == LOST:  # a lost track's size stops changing
            t.mean = t.mean.copy()
            t.mean[6:8] = 0.0
        if t.status == LOST or t.activated:  # the unconfirmed are not predicted
            t.mean, t.cov = kf_predict(t.mean, t.cov, form)
        if warp is not None:
            warp_track(t, warp, form)
    box = [to_xyxy(t.mean, form) for t in tracks]

    def fused(i, cols):
        c = 1 - iou(box[i], boxes[cols])
        return 1 - (1 - c) * scores[cols] if cfg.fuse_score else c

    pool = [i for i, t in enumerate(tracks) if t.status == LOST or t.activated]
    m1 = _match(pool, high, fused, cfg.match_thresh, slots)
    was_tracked = [i for i in pool if tracks[i].status == TRACKED and i not in m1]
    m2 = _match(was_tracked, low, lambda i, cols: 1 - iou(box[i], boxes[cols]),
                cfg.second_match_thresh, slots)
    unconfirmed = [i for i, t in enumerate(tracks) if t.status == TRACKED and not t.activated]
    left_high = [j for j in high if j not in m1.values()]
    m3 = _match(unconfirmed, left_high, fused, cfg.unconfirmed_match_thresh, slots)
    matched = {**m1, **m2, **m3}

    for i, j in matched.items():
        t = tracks[i]
        t.mean, t.cov = kf_update(t.mean, t.cov, to_meas(boxes[j], form), form)
        t.status, t.activated, t.hits = TRACKED, True, t.hits + 1
        t.score, t.cls, t.end_frame = float(scores[j]), int(classes[j]), st.frame_id
    for i in was_tracked:
        if i not in matched:
            tracks[i].status = LOST
    st.tracks = [t for i, t in enumerate(tracks) if i in matched or i not in unconfirmed]
    taken = set(m3.values())
    for j in left_high:
        if j in taken or scores[j] < cfg.new_track_thresh:
            continue
        if len(st.tracks) < slots:
            z = to_meas(boxes[j], form)
            mean, cov = kf_initiate(z, form)
            st.tracks.append(Track(st.next_id, TRACKED, st.frame_id == 1, mean, cov,
                                   float(scores[j]), int(classes[j]), np.zeros(1),
                                   st.frame_id, 1))
            st.next_id += 1
    st.tracks = [t for t in st.tracks if not (
        t.status == LOST and st.frame_id - t.end_frame > cfg.track_buffer)]
    return [(t.id, to_xyxy(t.mean, form)) for t in st.tracks
            if t.status == TRACKED and t.activated]
