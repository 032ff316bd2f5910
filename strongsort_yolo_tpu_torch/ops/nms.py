"""Fixed-shape class-aware NMS over a batch of frames.

Counterpart of ``strongsort_yolo_tpu/ops/nms.py`` with the frame axis
written out as a leading batch dimension, for the anchor-free heads' logits
(:func:`nms_from_logits`) and the anchor-based heads' decoded boxes
(:func:`non_max_suppression`):

- candidates are ranked by best-class logit (or confidence) and cut to a static
  ``pre_nms_topk`` by an exact, stable sort (equal values keep the lower
  anchor first, as ``lax.top_k`` does; ``torch.topk`` promises no order
  among ties);
- class-aware suppression shifts each box by ``cls * MAX_WH``;
- the keep mask comes from the K2 kernel (``ops/cuda/nms_kernel.py``)
  on CUDA and from :func:`_greedy_keep_fixpoint`, its plain version, on
  the CPU.

Output rows are confidence-sorted and padded to ``max_det``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from strongsort_yolo_tpu_torch.ops.cuda.nms_kernel import nms_keep
from strongsort_yolo_tpu_torch.ops.decode import anchors_from_indices, decode_boxes

# Class-offset magnitude: larger than any model-input coordinate, so
# boxes of different classes never intersect after offsetting.
MAX_WH = 7680.0


class Detections(NamedTuple):
    """Fixed-shape NMS output, leading batch dim B. Rows beyond
    ``count`` are zero padding."""

    boxes: torch.Tensor  # (B, max_det, 4) xyxy
    scores: torch.Tensor  # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    count: torch.Tensor  # (B,) int32 — number of valid rows
    valid: torch.Tensor  # (B, max_det) bool
    index: torch.Tensor  # (B, max_det) int32 — row in the raw predictions


def _greedy_keep_fixpoint(
    iou: torch.Tensor, valid: torch.Tensor, iou_thres: float
) -> torch.Tensor:
    """Fixpoint iteration equal to sequential greedy NMS, the plain
    version of K2. iou: (B, K, K) of score-desc-sorted candidates;
    valid: (B, K) bool. Returns (B, K) bool."""
    k = iou.shape[-1]
    upper = torch.triu(torch.ones(k, k, dtype=torch.bool, device=iou.device), 1)
    sup = ((iou > iou_thres) & upper).float()  # sup[j, i]: kept j kills i
    keep = valid
    for _ in range(k):
        killed = torch.bmm(keep.float()[:, None, :], sup)[:, 0] > 0.5
        new_keep = valid & ~killed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def _sort_desc(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_from_logits(
    box_logits: torch.Tensor,  # (B, A, 4 * reg_max) raw DFL logits
    cls_logits: torch.Tensor,  # (B, A, nc) raw class logits
    *,
    feat_dims: Sequence[tuple[int, int]],
    level_strides: Sequence[int],
    reg_max: int = 16,
    conf_thres: float = 0.3,
    iou_thres: float = 0.4,
    max_det: int = 300,
    pre_nms_topk: int = 512,
    agnostic: bool = False,
    class_filter: torch.Tensor | None = None,
) -> Detections:
    """Select the top ``pre_nms_topk`` anchors by best-class logit, decode
    only those, then suppress. Anchors and strides are computed from the
    anchor indices (``feat_dims``, ``level_strides``)."""
    a = cls_logits.shape[1]
    if class_filter is not None:
        cls_logits = torch.where(class_filter, cls_logits, -1e9)
    best_logit = cls_logits.amax(-1)
    k = min(pre_nms_topk, a)
    top_logit, top_idx = _sort_desc(best_logit.float(), k)
    top_conf = torch.sigmoid(top_logit)
    cls_all = cls_logits.argmax(-1)
    top_cls = torch.gather(cls_all, 1, top_idx).to(torch.int32)
    top_valid = top_conf >= conf_thres
    top_anchors, top_strides = anchors_from_indices(
        top_idx, feat_dims, level_strides
    )
    rows = torch.gather(
        box_logits, 1,
        top_idx[..., None].expand(-1, -1, box_logits.shape[-1]),
    ).float()
    top_boxes = decode_boxes(rows, top_anchors, top_strides, reg_max)
    return _nms_on_candidates(
        top_boxes, top_conf, top_cls, top_valid,
        conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
        agnostic=agnostic, row_ids=top_idx.to(torch.int32),
    )


def non_max_suppression(
    boxes: torch.Tensor,  # (B, N, 4) xyxy in model-input pixels
    scores: torch.Tensor,  # (B, N, nc) per-class confidences (sigmoided)
    *,
    conf_thres: float = 0.3,
    iou_thres: float = 0.4,
    max_det: int = 300,
    pre_nms_topk: int = 512,
    agnostic: bool = False,
    class_filter: torch.Tensor | None = None,
) -> Detections:
    """Class-aware greedy NMS over decoded predictions (the anchor-based
    v5 and v7 heads): rank by best-class confidence with non-candidates
    (confidence below ``conf_thres``) at -1, keep the top
    ``pre_nms_topk`` by the stable sort, then suppress as
    :func:`nms_from_logits` does. ``class_filter`` (nc,) bool zeroes the
    confidences of the other classes."""
    n = scores.shape[1]
    if class_filter is not None:
        scores = torch.where(class_filter, scores, 0.0)
    conf = scores.amax(-1)
    cls = scores.argmax(-1)
    k = min(pre_nms_topk, n)
    top_conf, top_idx = _sort_desc(torch.where(conf >= conf_thres, conf, -1.0), k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, top_idx).to(torch.int32)
    return _nms_on_candidates(
        top_boxes, top_conf, top_cls, top_conf >= conf_thres,
        conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
        agnostic=agnostic, row_ids=top_idx.to(torch.int32),
    )


def _nms_on_candidates(
    top_boxes: torch.Tensor,  # (B, K, 4) score-desc-sorted
    top_conf: torch.Tensor,  # (B, K)
    top_cls: torch.Tensor,  # (B, K) int32
    top_valid: torch.Tensor,  # (B, K) bool
    *,
    conf_thres: float,
    iou_thres: float,
    max_det: int,
    agnostic: bool,
    row_ids: torch.Tensor,  # (B, K) int32 row of each candidate
) -> Detections:
    """Suppression and the final ``max_det`` selection over pre-ranked
    candidates; ``index`` is ``row_ids[sel]``."""
    b, k = top_conf.shape
    offset = torch.where(top_valid, top_cls.float(), 0.0) * (
        0.0 if agnostic else MAX_WH
    )
    shifted = top_boxes + offset[..., None]
    keep = nms_keep(
        shifted, torch.where(top_valid, top_conf, -1.0),
        iou_thres=iou_thres, conf_thres=conf_thres,
    )
    kept_conf = torch.where(keep, top_conf, -1.0)
    out_k = min(max_det, k)
    out_conf, out_sel = _sort_desc(kept_conf, out_k)
    out_valid = out_conf >= conf_thres
    dev = top_conf.device
    valid = torch.zeros(b, max_det, dtype=torch.bool, device=dev)
    valid[:, :out_k] = out_valid
    boxes = torch.zeros(b, max_det, 4, dtype=torch.float32, device=dev)
    boxes[:, :out_k] = torch.where(
        out_valid[..., None],
        torch.gather(top_boxes, 1, out_sel[..., None].expand(-1, -1, 4)),
        0.0,
    )
    scores = torch.zeros(b, max_det, dtype=torch.float32, device=dev)
    scores[:, :out_k] = torch.where(out_valid, out_conf, 0.0)
    cls = torch.zeros(b, max_det, dtype=torch.int32, device=dev)
    cls[:, :out_k] = torch.where(out_valid, torch.gather(top_cls, 1, out_sel), 0)
    index = torch.zeros(b, max_det, dtype=torch.int32, device=dev)
    index[:, :out_k] = torch.where(
        out_valid, torch.gather(row_ids, 1, out_sel), 0
    )
    count = valid.sum(-1, dtype=torch.int32)
    return Detections(boxes, scores, cls, count, valid, index)
