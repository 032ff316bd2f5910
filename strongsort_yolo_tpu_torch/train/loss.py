"""Anchor-free detection loss: Task-Aligned assignment + CIoU + DFL.

Counterpart of ``strongsort_yolo_tpu/train/loss.py``, the v8-family
training objective:

- TAL assigner: per gt, pick top-k anchors by
  ``score^alpha * IoU^beta`` among anchors whose center lies inside
  the gt box; anchors claimed by several gts go to the best-aligned
  one. Target class scores are the align metric normalized per gt.
- classification: BCE against the soft target scores (sum-normalized);
- box: (1 - CIoU) weighted by target score on assigned anchors;
- DFL: cross-entropy on the two integer bins bracketing each true
  ltrb distance (stride units);
- segment: mask BCE of each foreground anchor cropped to its gt box;
  pose: keypoint distance and visibility BCE (:func:`detection_loss`).

Everything is fixed-shape: gts are padded to ``max_gt`` per image and
masked, so one step has no data-dependent shape and no host sync. The
JAX version vmaps a per-image function; here every tensor carries the
batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.ops.boxes import box_iou, ciou
from strongsort_yolo_tpu_torch.ops.decode import dfl_expectation


class LossWeights(NamedTuple):
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    seg: float = 2.5   # mask BCE (segment task)
    kpt: float = 6.0   # keypoint location (pose task)
    kobj: float = 1.0  # keypoint visibility BCE (pose task)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) gathered at idx (B, A) along M -> (B, A, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


@torch.no_grad()
def _assign(
    pred_scores: torch.Tensor,  # (B, A, nc) sigmoid probs
    pred_boxes: torch.Tensor,  # (B, A, 4) xyxy pixels
    anchor_points: torch.Tensor,  # (A, 2) pixels
    gt_boxes: torch.Tensor,  # (B, M, 4) xyxy pixels
    gt_cls: torch.Tensor,  # (B, M) int
    gt_valid: torch.Tensor,  # (B, M) bool
    *,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
):
    """TAL -> (assigned_gt (B, A), fg_mask (B, A), target_scores (B, A,
    nc)). It builds targets: no gradient flows through it (the JAX
    ``stop_gradient``; ``score ** 0.5`` has an infinite gradient where a
    sigmoid underflows to 0). Top-k takes the lower anchor index among
    equal aligns, as ``jax.lax.top_k`` does; indices are clipped as JAX
    gathers clip them."""
    m, a, nc = gt_boxes.shape[1], pred_boxes.shape[1], pred_scores.shape[2]
    ax, ay = anchor_points[None, None, :, 0], anchor_points[None, None, :, 1]
    inside = (
        (ax >= gt_boxes[..., 0, None]) & (ax < gt_boxes[..., 2, None])
        & (ay >= gt_boxes[..., 1, None]) & (ay < gt_boxes[..., 3, None])
    )  # (B, M, A)
    iou = box_iou(gt_boxes, pred_boxes)  # (B, M, A)
    cls_score = torch.gather(
        pred_scores.transpose(1, 2), 1,
        gt_cls.long().clamp(0, nc - 1)[..., None].expand(-1, -1, a),
    )  # (B, M, A): score of each anchor for the gt's class
    align = (cls_score**alpha) * (iou**beta)
    align = torch.where(inside & gt_valid[..., None], align, 0.0)

    # top-k anchors per gt
    k = min(topk, a)
    topk_vals, topk_idx = torch.sort(align, dim=-1, descending=True,
                                     stable=True)
    topk_vals, topk_idx = topk_vals[..., :k], topk_idx[..., :k]
    sel = torch.zeros_like(align, dtype=torch.bool).scatter_(
        -1, topk_idx, topk_vals > 1e-9)

    cand_align = torch.where(sel, align, 0.0)
    # resolve conflicts: anchor goes to the gt with max align
    best_val, _ = torch.max(cand_align, dim=1)  # (B, A)
    best_gt = torch.argmax(cand_align, dim=1)  # the first maximum
    fg = best_val > 1e-9
    assigned = torch.where(fg, best_gt, -1)

    # normalized target scores (per gt: align / max_align * max_iou)
    pos_align = torch.where(sel, align, 0.0)
    max_align = pos_align.amax(dim=-1, keepdim=True)  # (B, M, 1)
    max_iou = torch.where(sel, iou, 0.0).amax(dim=-1, keepdim=True)
    norm = pos_align * max_iou / torch.clamp(max_align, min=1e-9)  # (B, M, A)
    gi = assigned.clamp(0, m - 1)
    t_anchor = torch.gather(norm, 1, gi[:, None, :])[:, 0]  # (B, A)
    t_anchor = torch.where(fg, t_anchor, 0.0)
    t_cls = torch.gather(gt_cls.long(), 1, gi).clamp(0, nc - 1)
    target_scores = F.one_hot(t_cls, nc).to(align.dtype) * t_anchor[..., None]
    target_scores = torch.where(fg[..., None], target_scores, 0.0)
    return assigned, fg, target_scores


def _dfl_loss(box_logits: torch.Tensor, target_ltrb: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """Distribution focal loss on the bracketing bins.

    box_logits: (..., 4, reg_max); target_ltrb: (..., 4) in [0,
    reg_max-1] -> (...,).
    """
    t = torch.clamp(target_ltrb, 0.0, reg_max - 1.01)
    tl = torch.floor(t)
    tr = tl + 1.0
    wl = tr - t
    wr = 1.0 - wl
    logp = torch.log_softmax(box_logits, dim=-1)
    il = tl.long()
    ir = torch.clamp(il + 1, 0, reg_max - 1)
    ll = torch.gather(logp, -1, il[..., None])[..., 0]
    lr = torch.gather(logp, -1, ir[..., None])[..., 0]
    return -(wl * ll + wr * lr).mean(dim=-1)


def detection_loss(
    outputs: dict,
    targets: dict,
    anchors: torch.Tensor,  # (A, 2) feature units
    strides: torch.Tensor,  # (A, 1)
    *,
    nc: int = 80,
    reg_max: int = 16,
    weights: LossWeights = LossWeights(),
):
    """Batched detection loss.

    outputs: {"box_logits" (B, A, 4*reg_max), "cls_logits" (B, A, nc)}
    targets: {"boxes" (B, M, 4) xyxy pixels, "cls" (B, M) int,
              "valid" (B, M) bool}
    Returns (scalar loss, metrics dict of 0-d tensors).

    Task extras, keyed on presence:
    - segment: outputs carry "mask_coef" (B, A, nm) + "proto"
      (B, Hm, Wm, nm) and targets carry "masks" (B, M, Hm, Wm) {0,1}
      at proto resolution (input/4). Adds per-fg-anchor mask BCE
      cropped to the gt box and normalized by its proto-cell area.
    - pose: outputs carry "kpt_raw" (B, A, K*3) and targets carry
      "kpts" (B, M, K, 3) [x_px, y_px, vis]. Adds a gt-box-area-
      normalized squared-distance term on visible keypoints of fg
      anchors (decoded as ``ops/keypoints`` decodes them) plus
      visibility BCE.
    """
    anchor_px = anchors * strides  # (A, 2) pixels
    has_seg = "mask_coef" in outputs and "masks" in targets
    has_pose = "kpt_raw" in outputs and "kpts" in targets
    box_logits, cls_logits = outputs["box_logits"], outputs["cls_logits"]
    gt_boxes, gt_cls, gt_valid = targets["boxes"], targets["cls"], targets["valid"]
    b, a = box_logits.shape[:2]
    box_logits = box_logits.reshape(b, a, 4, reg_max)

    dist = dfl_expectation(box_logits, reg_max)
    lt, rb = dist[..., :2], dist[..., 2:]
    pred_boxes = torch.cat(
        [anchor_px - lt * strides, anchor_px + rb * strides], dim=-1
    )
    pred_scores = torch.sigmoid(cls_logits)
    assigned, fg, t_scores = _assign(
        pred_scores.detach(), pred_boxes.detach(), anchor_px, gt_boxes,
        gt_cls, gt_valid,
    )
    t_sum = torch.clamp(t_scores.sum(dim=(1, 2)), min=1.0)  # (B,)

    def fg_sum(per_anchor):
        """Per image: sum over the foreground anchors / t_sum -> (B,)."""
        return torch.where(fg, per_anchor, 0.0).sum(-1) / t_sum

    # BCE over all anchors against soft targets
    bce = _bce_logits(cls_logits, t_scores).sum(dim=(1, 2)) / t_sum

    # box + dfl on foreground anchors
    gi = assigned.clamp(0, gt_boxes.shape[1] - 1)
    tgt_box = _take(gt_boxes, gi)  # (B, A, 4)
    w = t_scores.sum(-1)  # (B, A) anchor weight
    box_l = fg_sum((1.0 - ciou(pred_boxes, tgt_box)) * w)

    # dfl targets: gt ltrb distances in stride units
    t_lt = (anchor_px - tgt_box[..., :2]) / strides
    t_rb = (tgt_box[..., 2:] - anchor_px) / strides
    t_ltrb = torch.cat([t_lt, t_rb], dim=-1)
    dfl_l = fg_sum(_dfl_loss(box_logits, t_ltrb, reg_max) * w)
    n_fg = fg.float().sum(-1)

    zero = torch.zeros_like(bce)
    seg_l = kpt_l = kobj_l = zero
    if has_seg:
        proto = outputs["proto"]
        hm, wm = proto.shape[1:3]
        # all-anchor mask logits: (B, A, Hm, Wm) floats, ~3 MB an image
        # at imgsz 160 and ~860 MB at 640
        logits_m = torch.einsum("bac,bhwc->bahw", outputs["mask_coef"], proto)
        t_mask = _take(targets["masks"], gi)  # (B, A, Hm, Wm)
        # crop to the gt box at proto resolution (input/4)
        xx = (torch.arange(wm, dtype=torch.float32, device=proto.device)
              + 0.5)[None, None, None, :]
        yy = (torch.arange(hm, dtype=torch.float32, device=proto.device)
              + 0.5)[None, None, :, None]
        bx = tgt_box / 4.0
        inside = (
            (xx >= bx[..., 0, None, None]) & (xx < bx[..., 2, None, None])
            & (yy >= bx[..., 1, None, None]) & (yy < bx[..., 3, None, None])
        )
        area = torch.clamp(
            (bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1]), min=1.0
        )
        per_a = (_bce_logits(logits_m, t_mask) * inside).sum(dim=(2, 3)) / area
        seg_l = fg_sum(per_a * w)
    if has_pose:
        kk = outputs["kpt_raw"].reshape(b, a, -1, 3)
        px = (kk[..., 0] * 2.0 + (anchors[:, 0:1] - 0.5)) * strides
        py = (kk[..., 1] * 2.0 + (anchors[:, 1:2] - 0.5)) * strides
        tk = _take(targets["kpts"], gi)  # (B, A, K, 3)
        vis = tk[..., 2]
        areas = torch.clamp(
            (tgt_box[..., 2] - tgt_box[..., 0])
            * (tgt_box[..., 3] - tgt_box[..., 1]),
            min=1.0,
        )[..., None]
        d2 = (px - tk[..., 0]) ** 2 + (py - tk[..., 1]) ** 2
        e = 1.0 - torch.exp(-d2 / (2.0 * areas * 0.04))
        nvis = torch.clamp(vis.sum(-1), min=1.0)
        kpt_l = fg_sum((vis * e).sum(-1) / nvis * w)
        kb = _bce_logits(kk[..., 2], vis).mean(-1)
        kobj_l = fg_sum(kb * w)

    loss = (
        weights.cls * bce.mean()
        + weights.box * box_l.mean()
        + weights.dfl * dfl_l.mean()
        + weights.seg * seg_l.mean()
        + weights.kpt * kpt_l.mean()
        + weights.kobj * kobj_l.mean()
    )
    metrics = {
        "loss": loss,
        "cls_loss": bce.mean(),
        "box_loss": box_l.mean(),
        "dfl_loss": dfl_l.mean(),
        "num_fg": n_fg.mean(),
    }
    if has_seg:
        metrics["seg_loss"] = seg_l.mean()
    if has_pose:
        metrics["kpt_loss"] = kpt_l.mean()
        metrics["kobj_loss"] = kobj_l.mean()
    return loss, metrics


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically-stable binary cross entropy with logits, the JAX
    formula term for term (its gradient is held against JAX's; the
    maximum splits a tie's gradient as ``jnp.maximum`` does)."""
    zero = logits.new_zeros(())
    return torch.maximum(logits, zero) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits))
    )
