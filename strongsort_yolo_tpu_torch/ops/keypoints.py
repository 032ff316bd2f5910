"""Pose keypoint decode of the anchor-free pose head.

Counterpart of ``strongsort_yolo_tpu/ops/keypoints.py``: per anchor the
head emits n_kpt x (dx, dy, conf logit), decoded as

    x = (2 * dx + anchor_x - 0.5) * stride
    y = (2 * dy + anchor_y - 0.5) * stride
    conf = sigmoid(logit)

Invisible keypoints keep their position and a low confidence
(``Keypoints.xy_masked`` in the pipeline zeroes them, as the reference
sees them).
"""

from __future__ import annotations

import torch


def decode_keypoints(
    kpt_raw: torch.Tensor,  # (..., M, nk) raw head rows of kept detections
    anchors: torch.Tensor,  # (..., M, 2) anchor centres, feature units
    strides: torch.Tensor,  # (..., M, 1)
    n_kpt: int = 17,
) -> torch.Tensor:
    """-> (..., M, n_kpt, 3): x, y in model-input pixels, conf in [0, 1]."""
    k = kpt_raw.reshape(*kpt_raw.shape[:-1], n_kpt, -1)
    x = (k[..., 0] * 2.0 + (anchors[..., None, 0] - 0.5)) * strides
    y = (k[..., 1] * 2.0 + (anchors[..., None, 1] - 0.5)) * strides
    conf = torch.sigmoid(k[..., 2]) if k.shape[-1] == 3 else torch.ones_like(x)
    return torch.stack([x, y, conf], dim=-1)


def scale_keypoints(
    kpts: torch.Tensor,  # (..., n_kpt, 3)
    gain: float,
    pad: tuple[float, float],
    orig_hw: tuple[int, int],
) -> torch.Tensor:
    """Model-input coordinates -> original frame coordinates, clipped to
    the frame (conf untouched). ``gain`` and ``pad`` as in
    :func:`~strongsort_yolo_tpu_torch.ops.boxes.scale_boxes`."""
    x = torch.clamp((kpts[..., 0] - pad[0]) / gain, 0.0, float(orig_hw[1]))
    y = torch.clamp((kpts[..., 1] - pad[1]) / gain, 0.0, float(orig_hw[0]))
    return torch.stack([x, y, kpts[..., 2]], dim=-1)
