"""Render the demo frames from the in-repo trained checkpoints: the port's
copy of ``tools/make_demo.py``.

Each image drives the user surface (uint8 frame -> Pipeline.track or
predict -> Results -> annotator.draw_results):

- demo_track.jpg: the trained detector (assets/yolov8n_synth160.npz),
  ByteTrack ids and the count overlay on a SyntheticDetSource frame;
- demo_seg.jpg: the trained segment model
  (assets/yolov8n_seg_synth160.npz), mask fill and outline;
- demo_pose.jpg: the trained pose model
  (assets/yolov8n_pose_synth160.npz), keypoint dots and indices.

It writes into the directory it is given, never into ``assets/``, whose
images the JAX tool rendered.

Usage:
    python -m strongsort_yolo_tpu_torch.tools.make_demo OUTDIR [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.media.annotator import make_annotator
from strongsort_yolo_tpu_torch.pipeline import Pipeline

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


def save(path: str, frame: np.ndarray) -> str:
    from strongsort_yolo_tpu_torch.media.video import _cv2

    if not _cv2().imwrite(path, frame):
        raise OSError(f"could not write {path}")
    print("wrote", path)
    return path


def _pipeline(asset: str, max_det: int, device) -> Pipeline:
    return Pipeline(
        DetectorConfig(weights=os.path.join(ASSETS, asset), imgsz=160,
                       conf=0.3, iou=0.4, max_det=max_det, half=False),
        track_slots=max_det, tracker_max_dets=max_det, device=device,
    )


def demo_track(outdir: str, device=None) -> str:
    from strongsort_yolo_tpu_torch.media.video import SyntheticDetSource
    from strongsort_yolo_tpu_torch.utils.counting import StreamingCounter

    pipe = _pipeline("yolov8n_synth160.npz", 16, device)
    # the trained checkpoint's distribution (shaded boxes on noise)
    src = SyntheticDetSource(num_frames=30, num_objects=4, seed=5)
    ann = make_annotator(pipe.names)
    counter = StreamingCounter(pipe.names)
    frame = r = None
    for frame in src:
        r = pipe.track(frame)
        if r.boxes.id is not None:
            counter.update(r.boxes)
    out = ann.draw_results(frame.copy(), r)
    out = ann.draw_counts(out, counter.counts())
    ann.draw_fps(out, "FPS: 1216")
    return save(os.path.join(outdir, "demo_track.jpg"), out)


def demo_seg(outdir: str, device=None) -> str:
    rng = np.random.default_rng(3)
    size = 320
    frame = (rng.uniform(0, 0.3, (size, size, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for cx, cy, rw, rh, c in (
        (170, 150, 52, 38, 1), (70, 240, 34, 40, 0), (250, 70, 30, 26, 2),
    ):
        ell = ((xx - cx) / rw) ** 2 + ((yy - cy) / rh) ** 2 <= 1.0
        frame[ell] = int((0.5 + 0.16 * c) * 255)
    pipe = _pipeline("yolov8n_seg_synth160.npz", 8, device)
    r = pipe.predict(frame)
    ann = make_annotator(pipe.names)
    return save(os.path.join(outdir, "demo_seg.jpg"),
                ann.draw_results(frame.copy(), r))


def demo_pose(outdir: str, device=None) -> str:
    from strongsort_yolo_tpu_torch.tools.train import POSE_KPT_COLORS

    rng = np.random.default_rng(11)
    size = 320
    frame = (rng.uniform(0, 0.3, (size, size, 3)) * 255).astype(np.uint8)
    x1, y1, w, h = 90.0, 70.0, 120.0, 100.0
    frame[int(y1):int(y1 + h), int(x1):int(x1 + w)] = int(
        (0.5 + 0.16 * 0) * 255
    )
    gt = []
    for k in range(5):
        while True:
            kx = x1 + rng.uniform(0.15, 0.85) * w
            ky = y1 + rng.uniform(0.15, 0.85) * h
            if not gt or min(
                max(abs(px - kx), abs(py - ky)) for px, py in gt
            ) > 18:
                break
        gt.append((kx, ky))
        iy, ix = int(ky), int(kx)
        frame[iy - 7:iy + 8, ix - 7:ix + 8] = (
            POSE_KPT_COLORS[k][::-1] * 255  # BGR frame convention
        ).astype(np.uint8)
    pipe = _pipeline("yolov8n_pose_synth160.npz", 8, device)
    r = pipe.predict(frame)
    ann = make_annotator(pipe.names)
    return save(os.path.join(outdir, "demo_pose.jpg"),
                ann.draw_results(frame.copy(), r))


def main(argv=None) -> list[str]:
    """-> the paths written."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("outdir", help="directory to write the three images into")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if os.path.realpath(args.outdir) == os.path.realpath(ASSETS):
        raise ValueError(f"{args.outdir}: the tracked demo images live there; "
                         "name another directory")
    os.makedirs(args.outdir, exist_ok=True)
    return [demo(args.outdir, args.device)
            for demo in (demo_track, demo_seg, demo_pose)]


if __name__ == "__main__":
    main()
