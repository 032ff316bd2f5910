"""Video sources and sinks with the reference loop's semantics.

Counterpart of ``strongsort_yolo_tpu/media/video.py``: camera-index
sources (any numeric string), an mp4v writer at a fixed 15 fps by
default (the reference's ``yolo_multi_model.py:252-260``), and the
synthetic sources (moving rectangles with known ground-truth tracks),
kept as they are, frame for frame.

``VideoReader`` and ``VideoWriter`` are OpenCV's and import ``cv2`` when
built; where it is missing they raise an ``ImportError`` that names the
native libav route (``media/native_decoder.py``), which the app tries
first for files.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "OpenCV (cv2) is not installed: camera sources, --show and the "
            "cv2 reader/writer need it; video files decode and encode "
            "without it through the native libav shims "
            "(strongsort_yolo_tpu_torch.media.native_decoder."
            "NativeVideoReader / NativeVideoWriter)") from e
    return cv2


class VideoReader:
    """Frame iterator over a file path or camera index string (cv2)."""

    def __init__(self, source: str):
        cv2 = _cv2()
        self.source = str(source)
        cap_arg = int(self.source) if self.source.isdigit() else self.source
        self.cap = cv2.VideoCapture(cap_arg)
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0

    @property
    def ok(self) -> bool:
        return self.cap.isOpened()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ret, frame = self.cap.read()
            if not ret:
                break
            yield frame

    def release(self):
        self.cap.release()


class VideoWriter:
    """mp4v writer (cv2)."""

    def __init__(
        self, path: str, width: int, height: int, fps: float = 15.0
    ):
        cv2 = _cv2()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self.out = cv2.VideoWriter(path, fourcc, fps, (width, height))

    def write(self, frame: np.ndarray):
        self.out.write(frame)

    def release(self):
        self.out.release()


class SyntheticSource:
    """Deterministic moving-rectangle scene with ground-truth tracks.

    Yields BGR frames; ``.truth(t)`` gives [(tid, x1, y1, x2, y2)] —
    the oracle for e2e tracking-metric tests (MOTA/IDF1) without media
    assets.
    """

    def __init__(
        self,
        num_frames: int = 60,
        size: tuple[int, int] = (480, 640),
        num_objects: int = 4,
        seed: int = 0,
    ):
        self.num_frames = num_frames
        self.h, self.w = size
        rng = np.random.default_rng(seed)
        self.fps = 30.0
        self.objs = []
        for i in range(num_objects):
            w = float(rng.uniform(40, 90))
            h = float(rng.uniform(50, 110))
            x = float(rng.uniform(0, self.w - w - num_frames * 4))
            y = float(rng.uniform(0, self.h - h - num_frames * 3))
            vx = float(rng.uniform(0.5, 3.5))
            vy = float(rng.uniform(0.5, 2.5))
            color = tuple(int(c) for c in rng.integers(60, 255, 3))
            self.objs.append((i + 1, x, y, w, h, vx, vy, color))

    def truth(self, t: int):
        out = []
        for tid, x, y, w, h, vx, vy, _ in self.objs:
            x1 = x + vx * t
            y1 = y + vy * t
            out.append((tid, x1, y1, x1 + w, y1 + h))
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        for t in range(self.num_frames):
            frame = np.full((self.h, self.w, 3), 30, np.uint8)
            for (tid, *_), (_, x1, y1, x2, y2) in zip(self.objs, self.truth(t)):
                color = self.objs[tid - 1][7]
                frame[int(y1) : int(y2), int(x1) : int(x2)] = color
            yield frame


class SyntheticDetSource:
    """Moving shaded rectangles matching tools/train.py's synthetic
    detection task (class = brightness bucket, noise background) — the
    video counterpart of the training distribution, so a checkpoint
    overfit offline on ``--synthetic`` yields real detections here.
    Used by the trained-model e2e test (model→NMS→tracker on actual
    signal, no oracle boxes)."""

    def __init__(
        self,
        num_frames: int = 40,
        size: tuple[int, int] = (320, 320),
        num_objects: int = 3,
        seed: int = 0,
    ):
        self.num_frames = num_frames
        self.h, self.w = size
        self.fps = 30.0
        rng = np.random.default_rng(seed)
        self._bg_seed = seed + 999
        self.objs = []
        for i in range(num_objects):
            # sizes sit inside the training range (15-40% of imgsz)
            w = float(rng.uniform(0.18, 0.35) * self.w)
            h = float(rng.uniform(0.18, 0.35) * self.h)
            x = float(rng.uniform(0, self.w - w - num_frames * 2.5))
            y = float(rng.uniform(0, self.h - h - num_frames * 2.0))
            vx = float(rng.uniform(0.8, 2.5))
            vy = float(rng.uniform(0.5, 2.0))
            cls = int(rng.integers(0, 3))
            self.objs.append((i + 1, x, y, w, h, vx, vy, cls))

    def truth(self, t: int):
        """[(tid, x1, y1, x2, y2)] ground truth at frame t."""
        out = []
        for tid, x, y, w, h, vx, vy, _ in self.objs:
            x1 = x + vx * t
            y1 = y + vy * t
            out.append((tid, x1, y1, x1 + w, y1 + h))
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self._bg_seed)
        for t in range(self.num_frames):
            # same stats as synthetic_batch: uniform [0, 0.3) noise bg
            frame = (
                rng.uniform(0.0, 0.3, (self.h, self.w, 3)) * 255
            ).astype(np.uint8)
            for (tid, *_, cls), (_, x1, y1, x2, y2) in zip(
                self.objs, self.truth(t)
            ):
                shade = int((0.5 + 0.16 * cls) * 255)
                frame[int(y1) : int(y2), int(x1) : int(x2)] = shade
            yield frame
