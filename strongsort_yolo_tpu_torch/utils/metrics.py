"""Tracking evaluation metrics: CLEAR-MOT (MOTA) and IDF1.

Counterpart of ``strongsort_yolo_tpu/utils/metrics.py``, numpy on the
host, the same numbers on the same inputs. Input format is
frame-indexed lists of (id, x1, y1, x2, y2) for ground truth and
hypotheses, as ``utils/labels.py`` files (``load_mot_labels``) or a
synthetic source's ``truth()`` give them.

Also the measures of the quality bars the trained checkpoints are held
to, on the frames of ``media/video`` (a clip's MOT metrics through
``Pipeline.track``, the segment mask against the ellipse, the keypoints
against the dots), so that the tests and the card's run read one copy.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def evaluate_mot(gt_frames, hyp_frames, iou_thresh: float = 0.5) -> dict:
    """gt_frames / hyp_frames: list per frame of [(tid, x1, y1, x2, y2)].

    Returns {"mota", "idf1", "fp", "fn", "idsw", "gt", "precision",
    "recall"} following CLEAR-MOT matching (carry last-frame
    correspondence, Hungarian on the rest above the IoU gate).
    """
    assert len(gt_frames) == len(hyp_frames)
    fp = fn = idsw = gt_total = matches_total = 0
    last_match: dict[int, int] = {}  # gt id -> hyp id
    # id-pair overlap counts for IDF1
    pair_counts: dict[tuple[int, int], int] = {}
    gt_counts: dict[int, int] = {}
    hyp_counts: dict[int, int] = {}

    for gts, hyps in zip(gt_frames, hyp_frames):
        g_ids = [g[0] for g in gts]
        h_ids = [h[0] for h in hyps]
        g_boxes = np.array([g[1:5] for g in gts], float).reshape(-1, 4)
        h_boxes = np.array([h[1:5] for h in hyps], float).reshape(-1, 4)
        gt_total += len(gts)
        for gid in g_ids:
            gt_counts[gid] = gt_counts.get(gid, 0) + 1
        for hid in h_ids:
            hyp_counts[hid] = hyp_counts.get(hid, 0) + 1

        iou = _iou_matrix(g_boxes, h_boxes)
        matched_g = set()
        matched_h = set()
        # 1) keep last-frame correspondences still valid
        for gi, gid in enumerate(g_ids):
            if gid in last_match:
                want = last_match[gid]
                for hi, hid in enumerate(h_ids):
                    if hid == want and hi not in matched_h and iou[gi, hi] >= iou_thresh:
                        matched_g.add(gi)
                        matched_h.add(hi)
                        pair_counts[(gid, hid)] = pair_counts.get((gid, hid), 0) + 1
                        break
        # 2) Hungarian over the rest
        free_g = [i for i in range(len(g_ids)) if i not in matched_g]
        free_h = [i for i in range(len(h_ids)) if i not in matched_h]
        if free_g and free_h:
            sub = iou[np.ix_(free_g, free_h)]
            cost = 1.0 - sub
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if sub[r, c] >= iou_thresh:
                    gi, hi = free_g[r], free_h[c]
                    gid, hid = g_ids[gi], h_ids[hi]
                    if gid in last_match and last_match[gid] != hid:
                        idsw += 1
                    last_match[gid] = hid
                    matched_g.add(gi)
                    matched_h.add(hi)
                    pair_counts[(gid, hid)] = pair_counts.get((gid, hid), 0) + 1
        matches_total += len(matched_g)
        fn += len(g_ids) - len(matched_g)
        fp += len(h_ids) - len(matched_h)

    mota = 1.0 - (fn + fp + idsw) / max(gt_total, 1)

    # IDF1: global bipartite matching of (gt id, hyp id) by overlap
    g_list = sorted(gt_counts)
    h_list = sorted(hyp_counts)
    if g_list and h_list:
        m = np.zeros((len(g_list), len(h_list)))
        for (gid, hid), n in pair_counts.items():
            m[g_list.index(gid), h_list.index(hid)] = n
        rows, cols = linear_sum_assignment(-m)
        idtp = m[rows, cols].sum()
    else:
        idtp = 0.0
    total_gt = sum(gt_counts.values())
    total_hyp = sum(hyp_counts.values())
    idf1 = 2 * idtp / max(total_gt + total_hyp, 1)
    precision = matches_total / max(matches_total + fp, 1)
    recall = matches_total / max(gt_total, 1)
    return {
        "mota": mota,
        "idf1": idf1,
        "fp": fp,
        "fn": fn,
        "idsw": idsw,
        "gt": gt_total,
        "precision": precision,
        "recall": recall,
    }


def track_clip(pipe, clip) -> dict:
    """:func:`evaluate_mot` of ``pipe.track`` over every frame of ``clip``
    (an iterable of BGR frames with ``truth(t)``, as the synthetic
    sources give it)."""
    gt, hyp = [], []
    for t, frame in enumerate(clip):
        r = pipe.track(frame)
        gt.append([tuple(g) for g in clip.truth(t)])
        hyp.append([(int(r.boxes.id[i]), *r.boxes.xyxy[i])
                    for i in range(len(r.boxes))])
    return evaluate_mot(gt, hyp)


def _mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def seg_bar(r, ell: np.ndarray, box) -> dict:
    """The segment bar's measures of ``r`` (Results of the ellipse frame,
    ``media/video.ellipse_frame``: its (H, W) bool mask ``ell`` and box):
    the top-scoring row's polygon, filled, against the ellipse and
    against the box. -> {"rows", "points" (the polygon's), "iou_ell",
    "iou_box", "box_err" (the row's x1 and y2 off the box's, the larger,
    px)}; with no row, only "rows"."""
    import cv2

    if len(r.boxes) == 0:
        return {"rows": 0}
    best = int(np.argmax(r.boxes.conf))
    x1, _, _, y2 = r.boxes.xyxy[best]
    poly = np.asarray(r.masks.xy[best], np.int32)
    pred = np.zeros(ell.shape, np.uint8)
    if len(poly) >= 3:
        cv2.fillPoly(pred, [poly], 1)
    pred = pred.astype(bool)
    box_mask = np.zeros_like(pred)
    bx = [int(v) for v in box]
    box_mask[bx[1]:bx[3], bx[0]:bx[2]] = True
    return {"rows": len(r.boxes), "points": len(poly),
            "iou_ell": _mask_iou(pred, ell), "iou_box": _mask_iou(pred, box_mask),
            "box_err": float(max(abs(x1 - box[0]), abs(y2 - box[3])))}


def pose_bar(r, gt: np.ndarray) -> dict:
    """The pose bar's measures of ``r`` (Results of the dots frame,
    ``media/video.dots_frame``, whose dot k is at ``gt[k]``): the
    top-scoring row's keypoints. -> {"rows", "shape" (of its keypoints'
    xy), "err" (mean distance of keypoint k to dot k, px), "conf" (mean
    keypoint confidence)}; with no row, only "rows"."""
    if len(r.boxes) == 0:
        return {"rows": 0}
    best = int(np.argmax(r.boxes.conf))
    kxy = np.asarray(r.keypoints.xy[best])
    return {"rows": len(r.boxes), "shape": kxy.shape,
            "err": float(np.linalg.norm(kxy - gt, axis=-1).mean())
            if kxy.shape == gt.shape else float("inf"),
            "conf": float(np.asarray(r.keypoints.conf[best]).mean())}


def load_mot_labels(path: str) -> list[list[tuple]]:
    """Parse a utils/labels.py file into per-frame hypothesis lists.
    Lines: ``frameId cls trackId conf x1 y1 x2 y2 -1 -1 -1 -1``."""
    frames: dict[int, list[tuple]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8:
                continue
            fid = int(parts[0])
            tid = int(parts[2])
            x1, y1, x2, y2 = map(float, parts[4:8])
            frames.setdefault(fid, []).append((tid, x1, y1, x2, y2))
    if not frames:
        return []
    n = max(frames) + 1
    return [frames.get(i, []) for i in range(n)]
