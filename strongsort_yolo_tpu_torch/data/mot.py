"""MOT16/17/20-format sequence loading and tracking evaluation.

Counterpart of ``strongsort_yolo_tpu/data/mot.py``. Reads the standard
MOTChallenge layout

    <seq>/seqinfo.ini
    <seq>/img1/000001.jpg ...
    <seq>/gt/gt.txt           (frame,id,x,y,w,h,conf,cls,vis)
    <seq>/det/det.txt         (frame,-1,x,y,w,h,conf,-1,-1,-1)

and evaluates tracker output with ``utils/metrics.py``. Detections come
from the model or from the public det.txt files (the
detector-independent protocol, ``track_sequence_public``).
"""

from __future__ import annotations

import configparser
import os

import numpy as np
import torch

from strongsort_yolo_tpu_torch.media.video import _cv2
from strongsort_yolo_tpu_torch.utils.metrics import evaluate_mot


class MotSequence:
    def __init__(self, seq_dir: str):
        self.dir = seq_dir
        ini = os.path.join(seq_dir, "seqinfo.ini")
        self.name = os.path.basename(seq_dir.rstrip("/"))
        self.fps = 30.0
        self.width = self.height = None
        self.img_dir = os.path.join(seq_dir, "img1")
        self.ext = ".jpg"
        self.seq_length = 0
        if os.path.exists(ini):
            cp = configparser.ConfigParser()
            cp.read(ini)
            s = cp["Sequence"]
            self.name = s.get("name", self.name)
            self.fps = float(s.get("frameRate", 30))
            self.width = int(s.get("imWidth", 0)) or None
            self.height = int(s.get("imHeight", 0)) or None
            self.img_dir = os.path.join(seq_dir, s.get("imDir", "img1"))
            self.ext = s.get("imExt", ".jpg")
            self.seq_length = int(s.get("seqLength", 0))
        frames = sorted(
            f for f in os.listdir(self.img_dir) if f.endswith(self.ext)
        ) if os.path.isdir(self.img_dir) else []
        self.frame_files = [os.path.join(self.img_dir, f) for f in frames]

    def __len__(self):
        # det-only fixtures (public protocol) carry no img1/ frames —
        # seqinfo.ini seqLength is the authoritative count then
        return len(self.frame_files) or self.seq_length

    def frames(self):
        cv2 = _cv2()
        for path in self.frame_files:
            yield cv2.imread(path)

    def ground_truth(self, *, person_only: bool = True, min_vis: float = 0.0):
        """-> per-frame [(tid, x1, y1, x2, y2)] lists (1-indexed frames
        mapped to 0-indexed list)."""
        path = os.path.join(self.dir, "gt", "gt.txt")
        return load_mot_txt(
            path, len(self), person_only=person_only, min_vis=min_vis
        )

    def public_detections(self, conf_thresh: float = 0.0):
        """det/det.txt -> per-frame [(x1, y1, x2, y2, conf)] lists."""
        path = os.path.join(self.dir, "det", "det.txt")
        out = [[] for _ in range(len(self))]
        if not os.path.exists(path):
            return out
        for row in _read_csvish(path):
            f = int(row[0]) - 1
            if 0 <= f < len(out) and row[6] >= conf_thresh:
                x, y, w, h = row[2:6]
                out[f].append((x, y, x + w, y + h, row[6]))
        return out


def _read_csvish(path):
    with open(path) as fh:
        for line in fh:
            parts = line.replace(",", " ").split()
            if parts:
                yield [float(p) for p in parts]


def load_mot_txt(path, num_frames, *, person_only=True, min_vis=0.0):
    out = [[] for _ in range(num_frames)]
    if not os.path.exists(path):
        return out
    for row in _read_csvish(path):
        f = int(row[0]) - 1
        if not (0 <= f < num_frames):
            continue
        if len(row) >= 8 and person_only and int(row[7]) not in (1, 2, -1):
            continue  # MOT17 gt class filter: pedestrian/person-on-vehicle
        if len(row) >= 7 and row[6] == 0:
            continue  # flagged-ignore entries
        if len(row) >= 9 and 0 <= row[8] < min_vis:
            continue  # visibility filter (negative = unknown, keep)
        tid = int(row[1])
        x, y, w, h = row[2:6]
        out[f].append((tid, x, y, x + w, y + h))
    return out


def save_mot_results(path, hyp_frames):
    """per-frame [(tid, x1, y1, x2, y2)] -> MOTChallenge results txt."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        for f, rows in enumerate(hyp_frames):
            for tid, x1, y1, x2, y2 in rows:
                fh.write(
                    f"{f + 1},{tid},{x1:.2f},{y1:.2f},{x2 - x1:.2f},"
                    f"{y2 - y1:.2f},1,-1,-1,-1\n"
                )


def evaluate_sequence(seq: MotSequence, hyp_frames, **kw):
    """Tracker hypotheses vs sequence gt -> CLEAR/IDF1 dict."""
    gt = seq.ground_truth()
    n = min(len(gt), len(hyp_frames))
    return evaluate_mot(gt[:n], hyp_frames[:n], **kw)


def track_sequence_public(
    seq: MotSequence,
    tracker_step,
    init_state,
    *,
    max_dets: int = 128,
    conf_thresh: float = 0.1,
):
    """Run a tracker step over a sequence's PUBLIC detections
    (detector-independent protocol). tracker_step(state, boxes, scores,
    cls, valid) -> (state, TrackOutputs), on one stream: inputs (1,
    max_dets, ...) on the device of ``init_state``, outputs (1, K, ...).
    Each frame's detections are laid out on the host and copied over,
    and its outputs come back in one copy: the protocol is sequential,
    so the host waits for every frame."""
    dets = seq.public_detections(conf_thresh)
    state = init_state
    device = init_state.mean.device
    cls = torch.zeros((1, max_dets), dtype=torch.int32, device=device)
    hyp = []
    for frame_dets in dets:
        boxes = np.zeros((max_dets, 4), np.float32)
        scores = np.zeros((max_dets,), np.float32)
        valid = np.zeros((max_dets,), bool)
        for i, d in enumerate(frame_dets[:max_dets]):
            boxes[i] = d[:4]
            scores[i] = min(max(d[4], 0.0), 1.0)
            valid[i] = True
        state, out = tracker_step(
            state,
            torch.from_numpy(boxes[None]).to(device),
            torch.from_numpy(scores[None]).to(device),
            cls,
            torch.from_numpy(valid[None]).to(device),
        )
        # ids are exact in float32
        rows = torch.cat([out.boxes[0], out.track_id[0, :, None].float(),
                          out.active[0, :, None].float()], 1).cpu().numpy()
        hyp.append(
            [
                (int(rows[i, 4]), *rows[i, :4])
                for i in range(len(rows))
                if rows[i, 5] > 0.5
            ]
        )
    return hyp
