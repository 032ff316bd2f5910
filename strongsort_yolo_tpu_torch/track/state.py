"""Fixed-slot track state of S streams.

Counterpart of ``strongsort_yolo_tpu/track/state.py`` with the stream
axis written out: every field has a leading (S,) dimension, where the
JAX package vmaps over a stacked pytree. ``feat`` is the ReID bank of
EMA appearance embeddings (StrongSORT, BoT-SORT with ReID); a tracker
without ReID carries a width-1 bank of zeros. Status encoding: EMPTY=0,
TRACKED=1, LOST=2; "unconfirmed" (StrongSORT: tentative) is TRACKED
with ``activated=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

STATUS_EMPTY = 0
STATUS_TRACKED = 1
STATUS_LOST = 2


class TrackState(NamedTuple):
    mean: torch.Tensor  # (S, K, 8) KF mean (cx, cy, w|a, h, velocities)
    cov: torch.Tensor  # (S, K, 8, 8) KF covariance
    track_id: torch.Tensor  # (S, K) int32; 0 = unassigned
    status: torch.Tensor  # (S, K) int32 STATUS_*
    activated: torch.Tensor  # (S, K) bool — ByteTrack is_activated
    score: torch.Tensor  # (S, K) float32 last detection confidence
    cls: torch.Tensor  # (S, K) int32 class id
    feat: torch.Tensor  # (S, K, D) EMA appearance embedding (L2-normed)
    end_frame: torch.Tensor  # (S, K) int32 frame of last update
    hits: torch.Tensor  # (S, K) int32 number of matched updates
    next_id: torch.Tensor  # (S,) int32 next track id to hand out
    frame_id: torch.Tensor  # (S,) int32 current frame counter
    dropped_births: torch.Tensor  # (S,) int32 births lost to slot overflow
    truncated_dets: torch.Tensor  # (S,) int32 valid detections that ranked
    # below tracker_max_dets and never reached association


class TrackOutputs(NamedTuple):
    """Per-frame tracker emission, per slot, leading (S,)."""

    boxes: torch.Tensor  # (S, K, 4) xyxy, KF-filtered
    track_id: torch.Tensor  # (S, K) int32
    score: torch.Tensor  # (S, K) float32
    cls: torch.Tensor  # (S, K) int32
    active: torch.Tensor  # (S, K) bool — rows to draw/log this frame
    det_index: torch.Tensor  # (S, K) int32 — detection that updated the
    # slot this frame (-1 if none)


def init_track_state(
    num_streams: int, num_slots: int = 128,
    device: torch.device | str = "cpu", *, feat_dim: int = 0,
) -> TrackState:
    s, k = num_streams, num_slots
    i32, f32 = torch.int32, torch.float32

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TrackState(
        mean=z(s, k, 8, dtype=f32),
        cov=z(s, k, 8, 8, dtype=f32),
        track_id=z(s, k),
        status=torch.full((s, k), STATUS_EMPTY, dtype=i32, device=device),
        activated=z(s, k, dtype=torch.bool),
        score=z(s, k, dtype=f32),
        cls=z(s, k),
        feat=z(s, k, max(feat_dim, 1), dtype=f32),
        end_frame=z(s, k),
        hits=z(s, k),
        next_id=torch.ones(s, dtype=i32, device=device),
        frame_id=z(s),
        dropped_births=z(s),
        truncated_dets=z(s),
    )
