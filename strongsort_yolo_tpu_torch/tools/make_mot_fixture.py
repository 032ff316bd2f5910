"""Generate a deterministic synthetic MOT-format fixture (det-only).

Counterpart of ``strongsort_yolo_tpu/tools/make_mot_fixture.py``, numpy
only: the same draws give the same files, so ``--seed 7`` writes
``tests/fixtures/MOT-synth01`` byte for byte. Produces ``gt/gt.txt`` +
``det/det.txt`` + ``seqinfo.ini`` for the PUBLIC-detection tracking
protocol (frames are not needed). The scene models the stressors real
MOT sequences have: staggered track births/deaths, crossing pairs
(ID-switch pressure), detector dropout, box jitter, confidence noise,
and false positives.

Usage:
    python -m strongsort_yolo_tpu_torch.tools.make_mot_fixture OUT_DIR \
        [--frames 300] [--tracks 10] [--seed 7]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

W, H = 960, 540


def make_tracks(num_frames: int, num_tracks: int, rng) -> list:
    """-> [(tid, start, [(x1,y1,x2,y2) per live frame])]."""
    tracks = []
    for tid in range(1, num_tracks + 1):
        span = int(rng.integers(int(num_frames * 0.4), num_frames))
        start = int(rng.integers(0, num_frames - span + 1))
        w = float(rng.uniform(30, 70))
        h = float(rng.uniform(80, 160))
        x = float(rng.uniform(0, W - w))
        y = float(rng.uniform(0, H - h))
        vx = float(rng.uniform(-2.5, 2.5))
        vy = float(rng.uniform(-1.0, 1.0))
        boxes = []
        for t in range(span):
            # mild acceleration noise
            vx += float(rng.normal(0, 0.05))
            vy += float(rng.normal(0, 0.03))
            x = min(max(x + vx, -w * 0.4), W - w * 0.6)
            y = min(max(y + vy, -h * 0.4), H - h * 0.6)
            boxes.append((x, y, x + w, y + h))
        tracks.append((tid, start, boxes))
    # two deliberate crossing pairs: mirror one track's path onto
    # another, offset so they swap sides mid-sequence
    if num_tracks >= 4:
        tid, start, boxes = tracks[0]
        rev = [
            (W - bx2, by1, W - bx1, by2) for (bx1, by1, bx2, by2) in boxes
        ]
        tracks[1] = (tracks[1][0], start, rev)
    return tracks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--tracks", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--drop", type=float, default=0.08, help="det dropout prob")
    ap.add_argument("--fp-rate", type=float, default=0.15, help="false positives per frame")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    tracks = make_tracks(args.frames, args.tracks, rng)

    gt_rows, det_rows = [], []
    for tid, start, boxes in tracks:
        for i, (x1, y1, x2, y2) in enumerate(boxes):
            f = start + i + 1  # MOT frames are 1-indexed
            w, h = x2 - x1, y2 - y1
            gt_rows.append((f, tid, x1, y1, w, h, 1, 1, 1.0))
            if rng.uniform() < args.drop:
                continue  # detector miss
            jx, jy = rng.normal(0, 2.0, 2)
            jw, jh = rng.normal(0, 2.5, 2)
            conf = float(np.clip(rng.normal(0.75, 0.12), 0.15, 0.99))
            det_rows.append(
                (f, -1, x1 + jx, y1 + jy, max(w + jw, 8), max(h + jh, 12), conf)
            )
    # false positives: low-conf clutter
    n_fp = int(args.fp_rate * args.frames)
    for _ in range(n_fp):
        f = int(rng.integers(1, args.frames + 1))
        w = float(rng.uniform(25, 80))
        h = float(rng.uniform(60, 170))
        det_rows.append(
            (f, -1, float(rng.uniform(0, W - w)), float(rng.uniform(0, H - h)),
             w, h, float(np.clip(rng.normal(0.35, 0.12), 0.12, 0.6)))
        )

    os.makedirs(os.path.join(args.out_dir, "gt"), exist_ok=True)
    os.makedirs(os.path.join(args.out_dir, "det"), exist_ok=True)
    with open(os.path.join(args.out_dir, "gt", "gt.txt"), "w") as fh:
        for f, tid, x, y, w, h, c, cls, vis in sorted(gt_rows):
            fh.write(f"{f},{tid},{x:.2f},{y:.2f},{w:.2f},{h:.2f},{c},{cls},{vis}\n")
    with open(os.path.join(args.out_dir, "det", "det.txt"), "w") as fh:
        for f, tid, x, y, w, h, conf in sorted(det_rows):
            fh.write(f"{f},{tid},{x:.2f},{y:.2f},{w:.2f},{h:.2f},{conf:.3f},-1,-1,-1\n")
    name = os.path.basename(args.out_dir.rstrip("/"))
    with open(os.path.join(args.out_dir, "seqinfo.ini"), "w") as fh:
        fh.write(
            f"[Sequence]\nname={name}\nimDir=img1\nframeRate=30\n"
            f"seqLength={args.frames}\nimWidth={W}\nimHeight={H}\nimExt=.jpg\n"
        )
    print(f"wrote {args.out_dir}: {len(gt_rows)} gt rows, {len(det_rows)} det rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
