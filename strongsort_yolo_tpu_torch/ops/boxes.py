"""Box geometry on tensors: format conversion, IoU matrices, and the map
from letterboxed coordinates back to the original frame.

Counterpart of ``strongsort_yolo_tpu/ops/boxes.py``. Every function
broadcasts over leading batch dimensions and keeps the expression order
of the JAX version, so results agree to the last bit where both sides
round the same operations.
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2). Last dim must be 4."""
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h). Last dim must be 4."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack(
        [(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1
    )


def xyxy2xyah(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, aspect=w/h, h) — DeepSORT KF state."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return torch.stack(
        [(x1 + x2) * 0.5, (y1 + y2) * 0.5, w / torch.clamp(h, min=1e-6), h],
        dim=-1,
    )


def xyah2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, aspect, h) -> (x1, y1, x2, y2)."""
    cx, cy, a, h = boxes.unbind(-1)
    w = a * h
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; clamps negative extents to zero."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU matrix between xyxy boxes: (..., N, 4) x (..., M, 4)
    -> (..., N, M), as ``inter / (area_a + area_b - inter + eps)``."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (box_area(a) + box_area(b) - inter + eps)


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise Complete-IoU between aligned xyxy boxes (..., 4) ->
    (...,), the regression term of ``train/loss.detection_loss``: ``eps``
    in the union and the diagonal, widths and heights clamped to ``eps``,
    and ``alpha`` differentiable, as in the JAX ``ciou``. Every clamp is a
    ``torch.maximum``, which splits the gradient of a tie in halves as
    ``jnp.maximum`` does (``torch.clamp`` passes all of it)."""

    def at_least(x, v):
        return torch.maximum(x, x.new_tensor(v))

    def area(x):
        return at_least(x[..., 2] - x[..., 0], 0.0) * at_least(
            x[..., 3] - x[..., 1], 0.0)

    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a) + area(b) - inter + eps
    iou = inter / union

    # enclosing box diagonal
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    diag2 = torch.sum((erb - elt) ** 2, dim=-1) + eps
    ac = (a[..., :2] + a[..., 2:]) * 0.5
    bc = (b[..., :2] + b[..., 2:]) * 0.5
    center_d2 = torch.sum((ac - bc) ** 2, dim=-1)

    wa = at_least(a[..., 2] - a[..., 0], eps)
    ha = at_least(a[..., 3] - a[..., 1], eps)
    wb = at_least(b[..., 2] - b[..., 0], eps)
    hb = at_least(b[..., 3] - b[..., 1], eps)
    v = (4.0 / math.pi**2) * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = v / (1.0 - iou + v + eps)
    return iou - center_d2 / diag2 - alpha * v


def scale_boxes(
    boxes: torch.Tensor, gain: float, pad: tuple[float, float],
    orig_hw: tuple[int, int],
) -> torch.Tensor:
    """Map xyxy boxes from letterboxed coords back to the original frame,
    clipped to it. ``gain`` and ``pad`` = (pad_x, pad_y) are the
    letterbox's; as Python scalars against float32 boxes they enter the
    arithmetic as float32, as in the JAX pipeline."""
    px, py = pad
    h, w = float(orig_hw[0]), float(orig_hw[1])
    x1 = torch.clamp((boxes[..., 0] - px) / gain, 0.0, w)
    y1 = torch.clamp((boxes[..., 1] - py) / gain, 0.0, h)
    x2 = torch.clamp((boxes[..., 2] - px) / gain, 0.0, w)
    y2 = torch.clamp((boxes[..., 3] - py) / gain, 0.0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
