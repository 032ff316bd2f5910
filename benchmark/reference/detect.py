"""Letterbox, decode, NMS and rescale of the reference, and the head
calibration that sets how many candidates a frame the weights give.

The letterbox is cv2.INTER_LINEAR sampling (half-pixel centres, no
antialias) into ``size`` x ``size`` keeping the aspect ratio, centred
gray-114 bars, BGR -> RGB, / 255. NMS keeps score-sorted, class-offset
candidates greedily: a candidate is kept unless a kept one before it
overlaps it by IoU above ``iou_thres``."""

from __future__ import annotations

import math
from typing import NamedTuple
import numpy as np
import torch
import torch.nn.functional as F

from reference.nn import Opts

PAD_VALUE = 114.0
MAX_WH = 7680.0  # class offset: larger than any input coordinate


class Geometry(NamedTuple):
    gain: float
    pad_x: float
    pad_y: float
    new_h: int
    new_w: int
    size: int


def geometry(h: int, w: int, size: int) -> Geometry:
    gain = min(size / h, size / w)
    new_w, new_h = int(round(w * gain)), int(round(h * gain))
    return Geometry(gain, (size - new_w) / 2.0, (size - new_h) / 2.0,
                    new_h, new_w, size)


def letterbox(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR -> (B, 3, size, size) float32 RGB in [0, 1]."""
    b, h, w, _ = frames.shape
    g = geometry(h, w, size)
    x = frames.permute(0, 3, 1, 2).float().flip(1)
    x = F.interpolate(x, size=(g.new_h, g.new_w), mode="bilinear",
                      align_corners=False, antialias=False)
    top, left = int(round(g.pad_y - 0.1)), int(round(g.pad_x - 0.1))
    out = torch.full((b, 3, size, size), PAD_VALUE, device=frames.device)
    out[:, :, top:top + g.new_h, left:left + g.new_w] = x
    return out / 255.0


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = torch.clamp(rb - lt, min=0).prod(-1)
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / (area_a + area_b - inter + 1e-7)


def dfl_boxes(rows: torch.Tensor, idx: torch.Tensor, imgsz: int) -> torch.Tensor:
    """DFL logits (B, K, 64) of the anchors ``idx`` -> xyxy input pixels."""
    anchors, strides, start = [], [], 0
    centres = []
    for s in (8, 16, 32):
        h = w = imgsz // s
        gy, gx = torch.meshgrid(torch.arange(h, device=rows.device),
                                torch.arange(w, device=rows.device), indexing="ij")
        centres.append(torch.stack([gx, gy], -1).reshape(-1, 2).float() + 0.5)
        strides.append(torch.full((h * w,), float(s), device=rows.device))
    anchors = torch.cat(centres)[idx]
    stride = torch.cat(strides)[idx][..., None]
    p = torch.softmax(rows.reshape(*rows.shape[:-1], 4, 16), -1)
    dist = (p * torch.arange(16, device=rows.device, dtype=torch.float32)).sum(-1)
    return torch.cat([(anchors - dist[..., :2]) * stride,
                      (anchors + dist[..., 2:]) * stride], -1)


def keep_mask(shifted: torch.Tensor, conf: torch.Tensor, iou_thres: float,
              conf_thres: float) -> torch.Tensor:
    """Greedy NMS of score-sorted, class-offset candidates (B, K, 4),
    (B, K): a candidate at or above ``conf_thres`` is kept unless a kept
    one before it overlaps it by IoU above ``iou_thres``."""
    over = box_iou(shifted, shifted) > iou_thres
    valid = conf >= conf_thres
    keep = torch.zeros_like(valid)
    for i in range(valid.shape[1]):
        keep[:, i] = valid[:, i] & ~(keep[:, :i] & over[:, :i, i]).any(1)
    return keep


def per_anchor(model, P, frames: torch.Tensor, det: dict, o: Opts | None = None):
    """Every anchor's box in frame pixels (clipped) and its per-class
    scores: -> (boxes (B, A, 4), scores (B, A, nc))."""
    h, w = frames.shape[1:3]
    size = det["imgsz"]
    g = geometry(h, w, size)
    o = o or Opts()
    out = model(P, letterbox(frames, size).to(o.dtype), o)
    if "boxes" in out:
        boxes, scores = out["boxes"], out["scores"]
    else:
        idx = torch.arange(out["cls_logits"].shape[1], device=frames.device)
        idx = idx.expand(out["cls_logits"].shape[0], -1)
        boxes = dfl_boxes(out["box_logits"], idx, size)
        scores = torch.sigmoid(out["cls_logits"])
    x = torch.clamp((boxes[..., 0::2] - g.pad_x) / g.gain, 0.0, float(w))
    y = torch.clamp((boxes[..., 1::2] - g.pad_y) / g.gain, 0.0, float(h))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1), scores


# the spread the calibration gives the raw outputs of an anchor head, per
# kind of channel: a random network's are nearly constant, so that every
# anchor would score alike
HEAD_STD = {"xy": 0.5, "wh": 0.5, "obj": 1.5, "cls": 1.5}
CLS_MARGIN = 0.05  # logits by which a DFL head's target-th anchor clears the threshold


CAL_CHUNK = 8  # frames a forward pass of the calibration


@torch.no_grad()
def calibrate_head(model, P, frames: torch.Tensor, size: int, conf: float,
                   target: int) -> None:
    """Set the output biases of the head in ``P`` (in place) so that about
    ``target`` anchors a frame of ``frames`` (S uint8 frames, letterboxed
    to ``size`` here) clear ``conf``, with margin, counted over all S
    together, so that every seed's tick has about S * ``target``. An
    anchor head first has its output rows scaled per level to the spread
    of HEAD_STD, then its objectness biases shifted (by bisection: its
    score is obj * cls); a DFL head has its class rows scaled to the
    spread of HEAD_STD["cls"], then its class biases shifted."""
    n = len(frames) * target

    def over(fn):
        return [fn(letterbox(frames[i:i + CAL_CHUNK], size))
                for i in range(0, len(frames), CAL_CHUNK)]

    if model.kind == "anchor":
        no = 5 + model.nc
        kinds = {"xy": [0, 1], "wh": [2, 3], "obj": [4], "cls": list(range(5, no))}
        levels = [torch.cat(parts) for parts in zip(*over(lambda x: model.raws(P, x)))]
        for conv, raw in zip(model.head, levels):
            raw = raw.view(raw.shape[0], model.na, no, -1)
            for kind, ch in kinds.items():
                gain = HEAD_STD[kind] / max(float(raw[:, :, ch].std()), 1e-12)
                rows = [a * no + c for a in range(model.na) for c in ch]
                P[conv.name + ".w"][rows] *= gain
                P[conv.name + ".b"][rows] *= gain
        obj, best = [], []
        for raws in over(lambda x: model.raws(P, x)):
            for raw in raws:
                raw = raw.view(raw.shape[0], model.na, no, -1)
                obj.append(raw[:, :, 4].reshape(-1))
                best.append(torch.sigmoid(raw[:, :, 5:]).amax(2).reshape(-1))
        obj, best = torch.cat(obj).float().cpu(), torch.cat(best).float().cpu()
        want = min(conf + 0.05, 0.5 * (conf + float(best.max())))
        lo, hi = -40.0, 40.0
        for _ in range(60):  # the n-th score rises with the offset
            mid = 0.5 * (lo + hi)
            kth = torch.topk(torch.sigmoid(obj + mid) * best, n).values[-1]
            lo, hi = (lo, mid) if float(kth) >= want else (mid, hi)
        for conv in model.head:
            P[conv.name + ".b"][4::no] += hi
        return
    # a random DFL head's class logits are nearly constant too: every
    # anchor would clear the threshold, or none; spread them first
    std = float(torch.cat(over(lambda x: model(P, x)["cls_logits"].float())).std())
    gain = HEAD_STD["cls"] / max(std, 1e-12)
    for branch in model.cls:
        P[branch.out.name + ".w"] *= gain
        P[branch.out.name + ".b"] *= gain
    logits = torch.cat(over(lambda x: model(P, x)["cls_logits"].float().amax(-1).reshape(-1)))
    kth = float(torch.topk(logits, n).values[-1])
    # the n-th anchor just above the threshold: bfloat16 logits tie
    offset = float(math.log(conf / (1 - conf)) + CLS_MARGIN - kth)
    for branch in model.cls:
        P[branch.out.name + ".b"] += offset
