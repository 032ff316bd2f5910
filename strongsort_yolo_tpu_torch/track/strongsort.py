"""StrongSORT as one fixed-shape step over S streams.

Counterpart of ``strongsort_yolo_tpu/track/strongsort.py`` (DeepSORT with
an EMA appearance bank, NSA Kalman noise, a motion + appearance cost with
chi-square gating and no matching cascade, camera-motion warps from the
caller, the tentative/confirmed/deleted lifecycle), with the stream axis
written out as the leading dimension of every tensor:

  1. NSA-KF predict every live track, apply the camera-motion warp;
  2. confirmed tracks x usable detections: lambda * cosine/2 +
     (1 - lambda) * Mahalanobis/gate, pairs outside the chi-square or the
     cosine gate forbidden; one assignment (one K3 launch for all S);
  3. IoU fallback: tentative tracks and confirmed tracks that matched
     last frame but not in stage 2 x leftover detections (the second K3
     launch);
  4. matched: NSA-KF update, EMA feature update, hits + 1, confirm at
     ``n_init``; unmatched tentative tracks die, confirmed ones after
     ``max_age`` missed frames; unmatched usable detections spawn
     tentative tracks.

A stream whose ``has_app`` is False this frame (an embed-cadence skip:
its detection features are all zero) associates in stage 2 by motion
alone, Mahalanobis within the chi-square gate scaled so that
``match_thresh`` spans the whole gate, and its EMA bank holds.

Confirmed is TRACKED with ``activated``, tentative TRACKED without.
"""

from __future__ import annotations

import dataclasses

import torch

from strongsort_yolo_tpu_torch.ops.assignment import solve_assignment
from strongsort_yolo_tpu_torch.ops.boxes import xyah2xyxy, xyxy2xyah
from strongsort_yolo_tpu_torch.track import cost as costs
from strongsort_yolo_tpu_torch.track import kalman
from strongsort_yolo_tpu_torch.track.bytetrack import (
    _take,
    apply_warp,
    ema_feature,
    unit_norm,
)
from strongsort_yolo_tpu_torch.track.state import (
    STATUS_EMPTY,
    STATUS_TRACKED,
    TrackOutputs,
    TrackState,
)


@dataclasses.dataclass(frozen=True)
class StrongSortConfig:
    """StrongSORT settings (the paper's defaults)."""

    det_thresh: float = 0.3  # min confidence to consider a detection
    max_cosine_distance: float = 0.45  # appearance gate (cos dist / 2)
    lambda_appearance: float = 0.98  # weight of appearance in the blend
    match_thresh: float = 0.45  # assignment cost limit, stage 1
    max_iou_distance: float = 0.7  # IoU fallback stage
    max_age: int = 30  # missed frames before a confirmed track dies
    n_init: int = 3  # hits to confirm
    ema_alpha: float = 0.9  # appearance bank EMA
    gmc_method: str = "ecc"  # "flow_tpu": estimated on the device
    # (track/gmc_flow.py); any other value but "none": the caller passes a
    # (2, 3) warp per stream and frame
    gate: float = kalman.CHI2_95_4DOF

    @property
    def form(self) -> str:
        return kalman.XYAH  # DeepSORT-family state


def _kf_update_slots(
    state: TrackState,
    matched: torch.Tensor,  # (S, K) bool
    slot_det: torch.Tensor,  # (S, K) det index (valid where matched)
    det_meas: torch.Tensor,  # (S, N, 4)
    det_scores: torch.Tensor,
    det_cls: torch.Tensor,
    det_feats: torch.Tensor,  # (S, N, D)
    cfg: StrongSortConfig,
    has_app: torch.Tensor | None = None,  # (S,) bool
) -> TrackState:
    """NSA-KF update of matched slots, EMA feature update (not for a
    stream without appearance), confirmation."""
    idx = slot_det.clamp(0, det_meas.shape[1] - 1)
    conf = _take(det_scores, idx)
    new_mean, new_cov = kalman.update(
        state.mean, state.cov, _take(det_meas, idx), cfg.form, conf=conf
    )
    m = matched
    new_hits = state.hits + 1
    confirmed = state.activated | (new_hits >= cfg.n_init)
    mixed = ema_feature(state.feat, _take(det_feats, idx), cfg.ema_alpha)
    upd = m if has_app is None else m & has_app[:, None]
    return state._replace(
        mean=torch.where(m[..., None], new_mean, state.mean),
        cov=torch.where(m[..., None, None], new_cov, state.cov),
        score=torch.where(m, conf, state.score),
        cls=torch.where(m, _take(det_cls, idx), state.cls),
        activated=torch.where(m, confirmed, state.activated),
        hits=torch.where(m, new_hits, state.hits),
        end_frame=torch.where(m, state.frame_id[:, None], state.end_frame),
        feat=torch.where(upd[..., None], mixed, state.feat),
    )


def strongsort_step(
    state: TrackState,
    det_boxes: torch.Tensor,  # (S, N, 4) xyxy
    det_scores: torch.Tensor,  # (S, N)
    det_cls: torch.Tensor,  # (S, N) int32
    det_valid: torch.Tensor,  # (S, N) bool
    det_feats: torch.Tensor,  # (S, N, D) L2-normalised ReID embeddings
    cfg: StrongSortConfig = StrongSortConfig(),
    *,
    warp: torch.Tensor | None = None,  # (S, 2, 3) camera-motion affine
    has_app: torch.Tensor | None = None,  # (S,) bool: det_feats are real
) -> tuple[TrackState, TrackOutputs]:
    """One tracker frame for S streams. Pure function of its inputs.
    ``has_app`` None means every stream has appearance this frame."""
    form = cfg.form
    state = state._replace(frame_id=state.frame_id + 1)
    usable = det_valid & (det_scores >= cfg.det_thresh)
    det_meas = xyxy2xyah(det_boxes)

    alive = state.status == STATUS_TRACKED
    confirmed = alive & state.activated
    tentative = alive & ~state.activated

    # 1. predict everything alive
    pred_mean, pred_cov = kalman.predict(state.mean, state.cov, form)
    state = state._replace(
        mean=torch.where(alive[..., None], pred_mean, state.mean),
        cov=torch.where(alive[..., None, None], pred_cov, state.cov),
    )
    if warp is not None:
        state = apply_warp(state, warp, form)

    # 2. appearance + motion association over confirmed tracks
    emb = costs.embedding_distance(state.feat, det_feats)  # (S, K, N)
    maha = kalman.gating_distance(state.mean, state.cov, det_meas, form)
    blended = costs.strongsort_cost(
        maha, emb, lambda_appearance=cfg.lambda_appearance, gate=cfg.gate
    )
    blended = torch.where(
        emb / 2.0 > cfg.max_cosine_distance, costs.INF_COST, blended
    )
    if has_app is not None:
        # a skip frame's features are all zero, so the cosine gate would
        # forbid every pair: motion only, the ranking kept
        gate = torch.full((), cfg.gate, device=maha.device)
        motion_only = torch.where(maha > cfg.gate, costs.INF_COST,
                                  (maha / gate) * cfg.match_thresh)
        blended = torch.where(has_app[:, None, None], blended, motion_only)
    c1 = costs.mask_cost(blended, confirmed, usable)
    a1 = solve_assignment(c1, cfg.match_thresh, confirmed, usable)
    m1 = a1.row_to_col >= 0

    # 3. IoU fallback: tentative + confirmed tracks that matched last frame
    # and missed now. Stage sets are disjoint and costs use the predicted
    # means, so the update of both stages is deferred and applied once.
    just_missed = confirmed & ~m1 & (
        state.end_frame == state.frame_id[:, None] - 1
    )
    iou_rows = tentative | just_missed
    left = usable & (a1.col_to_row < 0)
    slot_boxes = xyah2xyxy(state.mean[..., :4])
    c2 = costs.mask_cost(costs.iou_cost(slot_boxes, det_boxes), iou_rows, left)
    a2 = solve_assignment(c2, cfg.max_iou_distance, iou_rows, left)
    m2 = a2.row_to_col >= 0

    matched = m1 | m2
    slot_det = torch.where(m1, a1.row_to_col, a2.row_to_col)
    state = _kf_update_slots(
        state, matched, slot_det, det_meas, det_scores, det_cls, det_feats,
        cfg, has_app,
    )

    # 4. deaths: unmatched tentative now, confirmed past max_age
    missed = alive & ~matched
    too_old = (state.frame_id[:, None] - state.end_frame) > cfg.max_age
    kill = (missed & ~state.activated) | (missed & state.activated & too_old)
    state = state._replace(
        status=torch.where(kill, STATUS_EMPTY, state.status),
        track_id=torch.where(kill, 0, state.track_id),
        activated=state.activated & ~kill,
    )

    # 5. births: unmatched usable detections -> tentative tracks
    det_matched = (a1.col_to_row >= 0) | (a2.col_to_row >= 0)
    state, spawn_mask, spawn_det = _spawn_strongsort(
        state, usable & ~det_matched, det_meas, det_scores, det_cls,
        det_feats, cfg,
    )

    # 6. outputs: confirmed tracks updated this frame
    active = (
        (state.status == STATUS_TRACKED) & state.activated
        & (state.end_frame == state.frame_id[:, None])
    )
    det_index = torch.where(
        m1, a1.row_to_col,
        torch.where(m2, a2.row_to_col, torch.where(spawn_mask, spawn_det, -1)),
    ).to(torch.int32)
    out = TrackOutputs(
        boxes=xyah2xyxy(state.mean[..., :4]),
        track_id=state.track_id,
        score=state.score,
        cls=state.cls,
        active=active,
        det_index=det_index,
    )
    return state, out


def _spawn_strongsort(
    state: TrackState,
    birth: torch.Tensor,  # (S, N) bool dets to become new tracks
    det_meas: torch.Tensor,
    det_scores: torch.Tensor,
    det_cls: torch.Tensor,
    det_feats: torch.Tensor,
    cfg: StrongSortConfig,
) -> tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Claim EMPTY slots for new tentative tracks in det-index order.
    Returns (state, spawn_mask (S, K), slot_det (S, K))."""
    s, k = state.status.shape
    n = birth.shape[1]
    i32 = torch.int32
    empty = state.status == STATUS_EMPTY
    birth_rank = torch.cumsum(birth.to(i32), dim=1, dtype=i32) - 1
    slot_rank = torch.cumsum(empty.to(i32), dim=1, dtype=i32) - 1
    n_birth = birth.sum(1, dtype=i32)
    n_empty = empty.sum(1, dtype=i32)
    ranks = torch.where(birth & (birth_rank < k), birth_rank, k).long()
    det_of_rank = torch.full((s, k + 1), -1, dtype=i32, device=birth.device)
    det_of_rank.scatter_(
        1, ranks,
        torch.arange(n, dtype=i32, device=birth.device).expand(s, n).contiguous(),
    )
    slot_det = _take(det_of_rank[:, :k], slot_rank.clamp(0, k - 1))
    sm = empty & (slot_rank < n_birth[:, None]) & (slot_det >= 0)
    idx = slot_det.clamp(0, n - 1)
    new_mean, new_cov = kalman.initiate(_take(det_meas, idx), cfg.form)
    new_id = state.next_id[:, None] + _take(birth_rank, idx).clamp(min=0)
    return state._replace(
        mean=torch.where(sm[..., None], new_mean, state.mean),
        cov=torch.where(sm[..., None, None], new_cov, state.cov),
        track_id=torch.where(sm, new_id, state.track_id),
        status=torch.where(sm, STATUS_TRACKED, state.status),
        # n_init == 1 confirms at birth
        activated=torch.where(sm, cfg.n_init <= 1, state.activated),
        score=torch.where(sm, _take(det_scores, idx), state.score),
        cls=torch.where(sm, _take(det_cls, idx), state.cls),
        end_frame=torch.where(sm, state.frame_id[:, None], state.end_frame),
        hits=torch.where(sm, 1, state.hits),
        feat=torch.where(sm[..., None], unit_norm(_take(det_feats, idx)),
                         state.feat),
        next_id=state.next_id + torch.minimum(n_birth, n_empty),
        dropped_births=state.dropped_births + torch.clamp(n_birth - n_empty, min=0),
    ), sm, slot_det
