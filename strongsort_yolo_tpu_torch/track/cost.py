"""Association cost matrices, batched over streams.

Counterpart of ``strongsort_yolo_tpu/track/cost.py``: IoU cost,
detection-score fusion, cosine appearance distance, the BoT-SORT and
StrongSORT costs, and masking. Shapes: slots (S, K, ...), detections
(S, N, ...), costs (S, K, N).
"""

from __future__ import annotations

import torch

from strongsort_yolo_tpu_torch.ops.boxes import box_iou
from strongsort_yolo_tpu_torch.track import kalman

INF_COST = 1.0e4  # forbidden-pair cost (assignment treats as unmatchable)


def iou_cost(track_boxes: torch.Tensor, det_boxes: torch.Tensor) -> torch.Tensor:
    """1 - IoU between slot boxes (S, K, 4) and det boxes (S, N, 4), xyxy."""
    return 1.0 - box_iou(track_boxes, det_boxes)


def fuse_score(cost: torch.Tensor, det_scores: torch.Tensor) -> torch.Tensor:
    """ByteTrack fuse_score: similarity *= det confidence."""
    return 1.0 - (1.0 - cost) * det_scores[..., None, :]


def embedding_distance(
    track_feats: torch.Tensor, det_feats: torch.Tensor
) -> torch.Tensor:
    """Cosine distance between EMA track features (S, K, D) and detection
    features (S, N, D), both L2-normalised; a zero feature (empty slot)
    is at distance 1. The product runs in float64 and is rounded once, so
    it is full float32 precision on any device, whatever the TF32
    settings (the JAX package asks for Precision.HIGHEST)."""
    sim = torch.matmul(
        track_feats.double(), det_feats.double().transpose(-1, -2)
    ).float()
    return torch.clamp(1.0 - sim, 0.0, 2.0)


def botsort_fused_cost(
    d_iou: torch.Tensor, emb_dist: torch.Tensor | None,
    det_scores: torch.Tensor, *,
    proximity_thresh: float = 0.5, appearance_thresh: float = 0.25,
    with_fuse_score: bool = True,
) -> torch.Tensor:
    """BoT-SORT ``get_dists``: the (score-fused) IoU cost, min'd with half
    the appearance distance where that is within ``appearance_thresh``
    and the IoU cost within ``proximity_thresh``. Without ``emb_dist``
    it is the IoU cost alone, which is also ByteTrack's first stage."""
    cost = fuse_score(d_iou, det_scores) if with_fuse_score else d_iou
    if emb_dist is None:
        return cost
    emb = emb_dist / 2.0
    emb = torch.where((emb > appearance_thresh) | (d_iou > proximity_thresh),
                      1.0, emb)
    return torch.minimum(cost, emb)


def strongsort_cost(
    maha: torch.Tensor, emb_dist: torch.Tensor, *,
    lambda_appearance: float = 0.98, gate: float = kalman.CHI2_95_4DOF,
) -> torch.Tensor:
    """StrongSORT's cost: lambda * cosine/2 + (1 - lambda) * Mahalanobis /
    gate, with pairs outside the chi-square gate forbidden."""
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, and the card must match the CPU
    motion = maha / torch.full((), gate, device=maha.device)
    cost = lambda_appearance * (emb_dist / 2.0) + (1.0 - lambda_appearance) * motion
    return torch.where(maha > gate, INF_COST, cost)


def mask_cost(
    cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor
) -> torch.Tensor:
    """Forbid padded rows/cols."""
    ok = row_valid[..., :, None] & col_valid[..., None, :]
    return torch.where(ok, cost, INF_COST)
