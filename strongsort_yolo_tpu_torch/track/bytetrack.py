"""ByteTrack / BoT-SORT as one fixed-shape step over S streams.

Counterpart of ``strongsort_yolo_tpu/track/bytetrack.py`` (ultralytics
BYTETracker with the BoT-SORT extensions, ReID included), with the stream
axis written out as the leading dimension of every tensor:

  1. KF-predict tracked and lost tracks, apply the camera-motion warp;
  2. stage 1: high-confidence dets vs tracked+lost, (score-fused) IoU
     cost (BoT-SORT with ReID: min'd with the gated appearance distance),
     threshold ``match_thresh``;
  3. stage 2: remaining tracked vs low dets, plain IoU, threshold 0.5;
     unmatched tracked -> LOST;
  4. unconfirmed vs leftover high dets (stage 1's cost), threshold 0.7;
     unmatched unconfirmed -> removed; matched tracks with ReID update
     their EMA feature;
  5. births: leftover high dets with score >= ``new_track_thresh`` claim
     EMPTY slots (activated only on frame 1), with their feature;
  6. lost tracks older than ``track_buffer`` frames -> removed.

Each stage's S assignment problems are one ``solve_assignment`` call
(one K3 launch on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from strongsort_yolo_tpu_torch.ops.assignment import solve_assignment
from strongsort_yolo_tpu_torch.ops.boxes import (
    xyah2xyxy,
    xywh2xyxy,
    xyxy2xyah,
    xyxy2xywh,
)
from strongsort_yolo_tpu_torch.track import cost as costs
from strongsort_yolo_tpu_torch.track import kalman
from strongsort_yolo_tpu_torch.track.state import (
    STATUS_EMPTY,
    STATUS_LOST,
    STATUS_TRACKED,
    TrackOutputs,
    TrackState,
)


@dataclasses.dataclass(frozen=True)
class ByteTrackConfig:
    """Tracker config; key set mirrors ultralytics cfg/trackers/*.yaml,
    defaults are ultralytics 8.3's botsort.yaml."""

    tracker_type: str = "botsort"  # "bytetrack" | "botsort"
    track_high_thresh: float = 0.25
    track_low_thresh: float = 0.1
    new_track_thresh: float = 0.25
    track_buffer: int = 30
    match_thresh: float = 0.8
    fuse_score: bool = True
    # BoT-SORT extras
    gmc_method: str = "sparseOptFlow"  # "flow_tpu": estimated on the
    # device (track/gmc_flow.py); any other value but "none": the caller
    # passes a (2, 3) warp per stream and frame
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.25
    with_reid: bool = False
    # derived
    second_match_thresh: float = 0.5
    unconfirmed_match_thresh: float = 0.7
    reid_ema_alpha: float = 0.9

    @property
    def form(self) -> str:
        """KF measurement form: BoT-SORT filters xywh, ByteTrack xyah."""
        return kalman.XYWH if self.tracker_type == "botsort" else kalman.XYAH


def _to_meas(boxes_xyxy: torch.Tensor, form: str) -> torch.Tensor:
    return xyxy2xywh(boxes_xyxy) if form == kalman.XYWH else xyxy2xyah(boxes_xyxy)


def _to_xyxy(mean4: torch.Tensor, form: str) -> torch.Tensor:
    return xywh2xyxy(mean4) if form == kalman.XYWH else xyah2xyxy(mean4)


def _matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for tiny matrices as multiply-and-sum (full float32 on any
    device, whatever the TF32 settings)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _rows_times(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Each row of v (S, K, n) times m (S, n, n) transposed: v @ m^T."""
    return (v[:, :, None, :] * m[:, None, :, :]).sum(-1)


def apply_warp(state: TrackState, warp: torch.Tensor, form: str) -> TrackState:
    """Apply per-stream GMC affine warps (S, 2, 3) to all track means.

    XYWH (BoT-SORT): ultralytics ``STrack.multi_gmc`` — kron(I4, R) hits
    every state pair, the translation is added to the position, the
    covariance gets the full R8 congruence. XYAH: position only."""
    s = warp.shape[0]
    r = warp[:, :, :2].to(torch.float32)  # (S, 2, 2)
    t = warp[:, :, 2].to(torch.float32)[:, None, :]  # (S, 1, 2)
    if form == kalman.XYWH:
        r8 = torch.kron(torch.eye(4, device=warp.device), r)  # (S, 8, 8)
        mean = _rows_times(state.mean, r8)
        mean = torch.cat([mean[..., :2] + t, mean[..., 2:]], dim=-1)
    else:
        xy = _rows_times(state.mean[..., :2], r) + t
        mean = torch.cat([xy, state.mean[..., 2:]], dim=-1)
        r8 = torch.eye(8, dtype=torch.float32, device=warp.device).repeat(s, 1, 1)
        r8[:, :2, :2] = r
    r8 = r8[:, None]  # (S, 1, 8, 8) over slots
    cov = _matmul_small(_matmul_small(r8, state.cov), r8.transpose(-1, -2))
    nonempty = state.status != STATUS_EMPTY
    return state._replace(
        mean=torch.where(nonempty[..., None], mean, state.mean),
        cov=torch.where(nonempty[..., None, None], cov, state.cov),
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (S, N, ...) gathered at idx (S, K) along N."""
    idx = idx.long()
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(
        x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
            *idx.shape, *x.shape[2:]
        )
    )


def unit_norm(x: torch.Tensor) -> torch.Tensor:
    """Rows of x scaled to unit L2 norm (zero rows stay zero)."""
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-12)


def ema_feature(feat: torch.Tensor, det_feat: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """The appearance bank's update: alpha * old + (1 - alpha) * new,
    L2-normalised; a slot without a feature yet takes the new one."""
    mixed = alpha * feat + (1.0 - alpha) * det_feat
    has_old = feat.abs().sum(-1, keepdim=True) > 1e-8
    return unit_norm(torch.where(has_old, mixed, det_feat))


def _masked_kf_update(
    state: TrackState,
    slot_matched: torch.Tensor,  # (S, K) bool
    slot_det: torch.Tensor,  # (S, K) det index (valid where matched)
    det_meas: torch.Tensor,  # (S, N, 4)
    det_scores: torch.Tensor,
    det_cls: torch.Tensor,
    det_feats: torch.Tensor | None,  # (S, N, D)
    cfg: ByteTrackConfig,
) -> TrackState:
    """KF-update matched slots with their detections; set track fields
    and, with ReID, the EMA feature."""
    idx = slot_det.clamp(0, det_meas.shape[1] - 1)
    new_mean, new_cov = kalman.update(
        state.mean, state.cov, _take(det_meas, idx), cfg.form
    )
    m = slot_matched
    feat = state.feat
    if det_feats is not None:
        mixed = ema_feature(state.feat, _take(det_feats, idx),
                            cfg.reid_ema_alpha)
        feat = torch.where(m[..., None], mixed, state.feat)
    return state._replace(
        feat=feat,
        mean=torch.where(m[..., None], new_mean, state.mean),
        cov=torch.where(m[..., None, None], new_cov, state.cov),
        score=torch.where(m, _take(det_scores, idx), state.score),
        cls=torch.where(m, _take(det_cls, idx), state.cls),
        status=torch.where(m, STATUS_TRACKED, state.status),
        activated=state.activated | m,
        end_frame=torch.where(m, state.frame_id[:, None], state.end_frame),
        hits=torch.where(m, state.hits + 1, state.hits),
    )


def bytetrack_step(
    state: TrackState,
    det_boxes: torch.Tensor,  # (S, N, 4) xyxy
    det_scores: torch.Tensor,  # (S, N)
    det_cls: torch.Tensor,  # (S, N) int32
    det_valid: torch.Tensor,  # (S, N) bool
    cfg: ByteTrackConfig = ByteTrackConfig(),
    *,
    det_feats: torch.Tensor | None = None,  # (S, N, D) L2-normed ReID
    warp: torch.Tensor | None = None,  # (S, 2, 3) GMC affine
) -> tuple[TrackState, TrackOutputs]:
    """One tracker frame for S streams. Pure function of its inputs.
    ``det_feats`` is used only when ``cfg.with_reid``."""
    use_reid = cfg.with_reid and det_feats is not None
    if not use_reid:
        det_feats = None
    form = cfg.form
    state = state._replace(frame_id=state.frame_id + 1)

    high = det_valid & (det_scores >= cfg.track_high_thresh)
    low = det_valid & (det_scores >= cfg.track_low_thresh) & (
        det_scores < cfg.track_high_thresh
    )
    det_meas = _to_meas(det_boxes, form)

    tracked = state.status == STATUS_TRACKED
    tracked_act = tracked & state.activated
    unconfirmed = tracked & ~state.activated
    lost = state.status == STATUS_LOST
    pool = tracked_act | lost

    # --- KF predict (pool only; lost tracks keep size velocity zeroed) ---
    pred_mean, pred_cov = kalman.predict(
        state.mean, state.cov, form, still_mask=lost
    )
    state = state._replace(
        mean=torch.where(pool[..., None], pred_mean, state.mean),
        cov=torch.where(pool[..., None, None], pred_cov, state.cov),
    )
    if warp is not None:
        state = apply_warp(state, warp, form)

    slot_boxes = _to_xyxy(state.mean[..., :4], form)

    # --- stage 1: pool vs high dets ---
    d_iou = costs.iou_cost(slot_boxes, det_boxes)
    # stages 1 and 3 share this cost: the features it reads change only
    # in the deferred update below
    emb = None
    if use_reid and cfg.tracker_type == "botsort":
        emb = costs.embedding_distance(state.feat, det_feats)
    fused = costs.botsort_fused_cost(
        d_iou, emb, det_scores,
        proximity_thresh=cfg.proximity_thresh,
        appearance_thresh=cfg.appearance_thresh,
        with_fuse_score=cfg.fuse_score,
    )
    c1 = costs.mask_cost(fused, pool, high)
    a1 = solve_assignment(c1, cfg.match_thresh, pool, high)
    m1 = a1.row_to_col >= 0
    det_matched1 = a1.col_to_row >= 0

    # The three stages match disjoint slot sets, and each stage's costs
    # use the predicted means of its own slots, so the KF and field
    # updates are deferred and applied once below.

    # --- stage 2: unmatched tracked tracks vs low dets (IoU only) ---
    r_tracked = tracked_act & ~m1
    c2 = costs.mask_cost(d_iou, r_tracked, low)
    a2 = solve_assignment(c2, cfg.second_match_thresh, r_tracked, low)
    m2 = a2.row_to_col >= 0
    to_lost = r_tracked & ~m2

    # --- stage 3: unconfirmed tracks vs leftover high dets ---
    left_high = high & ~det_matched1
    c3 = costs.mask_cost(fused, unconfirmed, left_high)
    a3 = solve_assignment(c3, cfg.unconfirmed_match_thresh, unconfirmed, left_high)
    m3 = a3.row_to_col >= 0

    # --- deferred combined update for the three (disjoint) stages ---
    matched = m1 | m2 | m3
    slot_det = torch.where(
        m1, a1.row_to_col, torch.where(m2, a2.row_to_col, a3.row_to_col)
    )
    state = _masked_kf_update(
        state, matched, slot_det, det_meas, det_scores, det_cls, det_feats,
        cfg,
    )
    state = state._replace(status=torch.where(to_lost, STATUS_LOST, state.status))
    drop_unconf = unconfirmed & ~m3
    state = state._replace(
        status=torch.where(drop_unconf, STATUS_EMPTY, state.status),
        track_id=torch.where(drop_unconf, 0, state.track_id),
        activated=state.activated & ~drop_unconf,
    )

    # --- births: leftover high dets above new_track_thresh ---
    birth = left_high & ~(a3.col_to_row >= 0) & (
        det_scores >= cfg.new_track_thresh
    )
    state, spawn_mask, spawn_det = _spawn(
        state, birth, det_meas, det_scores, det_cls, det_feats, cfg
    )

    # --- prune stale lost tracks ---
    stale = (state.status == STATUS_LOST) & (
        (state.frame_id[:, None] - state.end_frame) > cfg.track_buffer
    )
    state = state._replace(
        status=torch.where(stale, STATUS_EMPTY, state.status),
        track_id=torch.where(stale, 0, state.track_id),
        activated=state.activated & ~stale,
    )

    active = (state.status == STATUS_TRACKED) & state.activated
    det_index = torch.where(
        m1, a1.row_to_col,
        torch.where(
            m2, a2.row_to_col,
            torch.where(m3, a3.row_to_col, torch.where(spawn_mask, spawn_det, -1)),
        ),
    ).to(torch.int32)
    out = TrackOutputs(
        boxes=_to_xyxy(state.mean[..., :4], form),
        track_id=state.track_id,
        score=state.score,
        cls=state.cls,
        active=active,
        det_index=det_index,
    )
    return state, out


def _spawn(
    state: TrackState,
    birth: torch.Tensor,  # (S, N) bool dets to become new tracks
    det_meas: torch.Tensor,
    det_scores: torch.Tensor,
    det_cls: torch.Tensor,
    det_feats: torch.Tensor | None,
    cfg: ByteTrackConfig,
) -> tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Allocate EMPTY slots to birth detections in det-index order (track
    ids then follow the reference's sequential next_id order). Returns
    (state, spawn_mask (S, K), slot_det (S, K))."""
    s, k = state.status.shape
    n = birth.shape[1]
    i32 = torch.int32
    empty = state.status == STATUS_EMPTY
    birth_rank = torch.cumsum(birth.to(i32), dim=1, dtype=i32) - 1
    slot_rank = torch.cumsum(empty.to(i32), dim=1, dtype=i32) - 1
    n_birth = birth.sum(1, dtype=i32)
    n_empty = empty.sum(1, dtype=i32)

    # slot -> det: the slot of rank r takes the det of rank r
    ranks = torch.where(birth & (birth_rank < k), birth_rank, k).long()
    det_of_rank = torch.full((s, k + 1), -1, dtype=i32, device=birth.device)
    det_of_rank.scatter_(
        1, ranks,
        torch.arange(n, dtype=i32, device=birth.device).expand(s, n).contiguous(),
    )
    slot_det = _take(det_of_rank[:, :k], slot_rank.clamp(0, k - 1))
    spawn_mask = empty & (slot_rank < n_birth[:, None]) & (slot_det >= 0)

    idx = slot_det.clamp(0, n - 1)
    new_mean, new_cov = kalman.initiate(_take(det_meas, idx), cfg.form)
    new_id = state.next_id[:, None] + _take(birth_rank, idx).clamp(min=0)
    first_frame = (state.frame_id == 1)[:, None].expand(s, k)
    sm = spawn_mask
    feat = state.feat
    if det_feats is not None:
        feat = torch.where(sm[..., None], unit_norm(_take(det_feats, idx)),
                           state.feat)
    return state._replace(
        feat=feat,
        mean=torch.where(sm[..., None], new_mean, state.mean),
        cov=torch.where(sm[..., None, None], new_cov, state.cov),
        track_id=torch.where(sm, new_id, state.track_id),
        status=torch.where(sm, STATUS_TRACKED, state.status),
        activated=torch.where(sm, first_frame, state.activated),
        score=torch.where(sm, _take(det_scores, idx), state.score),
        cls=torch.where(sm, _take(det_cls, idx), state.cls),
        end_frame=torch.where(sm, state.frame_id[:, None], state.end_frame),
        hits=torch.where(sm, 1, state.hits),
        next_id=state.next_id + torch.minimum(n_birth, n_empty),
        dropped_births=state.dropped_births + torch.clamp(n_birth - n_empty, min=0),
    ), sm, slot_det
