"""Video sources and sinks with the reference loop's semantics.

Counterpart of ``strongsort_yolo_tpu/media/video.py``: camera-index
sources (any numeric string), an mp4v writer at a fixed 15 fps by
default (the reference's ``yolo_multi_model.py:252-260``), and the
synthetic sources (moving rectangles with known ground-truth tracks, and
the occlusion-relay benchmark clip of the sequence-quality rows),
kept as they are, frame for frame; and the frames of the JAX package's
quality bars, its tests' own (the occlusion bounce of
tests/test_reid_quality.py, the ellipse and the dots of
tests/test_trained_seg_pose.py), frame for frame.

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


class BounceClip:
    """The occlusion-bounce clip of the JAX package's
    tests/test_reid_quality.py, frame for frame: two gradient-shaded
    squares (id 1 bright at the bottom, id 2 bright at the top) slide
    towards a static wall (id 3), vanish behind it on the same frame
    (once ``HIDE_PX`` of a square overlaps it), bounce while hidden and
    re-emerge on their own sides on the same frame, 29 frames later. Their
    speeds differ (2.3 and -2.7 px a frame), so the coasted predictions
    cross and motion alone prefers the swapped pairing: appearance has to
    keep the ids. Truth holds a square only while it is drawn. The noise
    background comes from one generator made with the clip, so a second
    pass over the clip draws other noise, as the original does."""

    WALL = (116.0, 108.0, 204.0, 196.0)
    HIDE_PX = 16.0

    def __init__(self, num_frames: int = 64, size=(320, 320), seed: int = 5):
        self.num_frames = num_frames
        self.h, self.w = size
        self._bg = np.random.default_rng(seed)
        self.box = 64.0
        self.y = {1: 120.0, 2: 126.0}
        self.grad = {1: (0.4, 0.9), 2: (0.9, 0.4)}  # top -> bottom shade
        # both cross the hide threshold at t=16 and re-emerge at t=45
        self.v = {1: 2.3, 2: -2.7}
        self.x0 = {1: 68.0 - 16 * 2.3, 2: 188.0 + 16 * 2.7}
        self.t_bounce = 30  # both fully hidden by the wall here

    def _x(self, tid: int, t: int) -> float:
        tb, v = self.t_bounce, self.v[tid]
        return self.x0[tid] + (v * t if t <= tb else v * (2 * tb - t))

    def _hidden(self, tid: int, t: int) -> bool:
        x1 = self._x(tid, t)
        wx1, _, wx2, _ = self.WALL
        overlap = min(x1 + self.box, wx2) - max(x1, wx1)
        return overlap >= self.HIDE_PX

    def truth(self, t: int):
        """[(tid, x1, y1, x2, y2)]: the drawn squares and the wall."""
        rows = [(tid, self._x(tid, t), self.y[tid],
                 self._x(tid, t) + self.box, self.y[tid] + self.box)
                for tid in (1, 2) if not self._hidden(tid, t)]
        rows.append((3, *self.WALL))
        return rows

    def __iter__(self) -> Iterator[np.ndarray]:
        b = int(self.box)
        for t in range(self.num_frames):
            frame = (self._bg.uniform(0, 0.3, (self.h, self.w, 3)) * 255
                     ).astype(np.uint8)
            for tid in (1, 2):
                if self._hidden(tid, t):
                    continue
                x1, y1 = int(self._x(tid, t)), int(self.y[tid])
                lo, hi = self.grad[tid]
                g = (np.linspace(lo, hi, b)[:, None, None] * 255)
                frame[y1:y1 + b, x1:x1 + b] = g.astype(np.uint8)
            wx1, wy1, wx2, wy2 = (int(v) for v in self.WALL)
            frame[wy1:wy2, wx1:wx2] = int(0.66 * 255)  # the wall on top
            yield frame


def ellipse_frame(size: int = 320):
    """The frame of the trained segment model's bar (the JAX package's
    tests/test_trained_seg_pose.py): one ellipse of the class-1 shade on
    noise. -> (frame (size, size, 3) uint8, the ellipse's (size, size)
    bool mask, its box (x1, y1, x2, y2))."""
    rng = np.random.default_rng(3)
    frame = (rng.uniform(0, 0.3, (size, size, 3)) * 255).astype(np.uint8)
    cx, cy, rw, rh = 170.0, 150.0, 52.0, 38.0
    yy, xx = np.mgrid[0:size, 0:size]
    ell = ((xx - cx) / rw) ** 2 + ((yy - cy) / rh) ** 2 <= 1.0
    frame[ell] = int((0.5 + 0.16 * 1) * 255)
    return frame, ell, (cx - rw, cy - rh, cx + rw, cy + rh)


def dots_frame():
    """The frame of the trained pose models' bar (the JAX package's
    tests/test_trained_seg_pose.py): a box of the class-0 shade on noise
    with five 15-px dots, dot k in the BGR mirror of keypoint k's
    training color, at least 18 px apart. -> (frame (320, 320, 3) uint8,
    the dots' centres (5, 2) in frame px)."""
    from strongsort_yolo_tpu_torch.tools.train import POSE_KPT_COLORS

    rng = np.random.default_rng(11)
    size = 320
    frame = (rng.uniform(0, 0.3, (size, size, 3)) * 255).astype(np.uint8)
    x1, y1, w, h = 90.0, 70.0, 120.0, 100.0
    frame[int(y1):int(y1 + h), int(x1):int(x1 + w)] = int(0.5 * 255)
    gt = []
    for k in range(5):
        while True:  # keep the dots from covering each other
            kx = x1 + rng.uniform(0.15, 0.85) * w
            ky = y1 + rng.uniform(0.15, 0.85) * h
            if not gt or min(max(abs(px - kx), abs(py - ky))
                             for px, py in gt) > 18:
                break
        iy, ix = int(ky), int(kx)
        frame[iy - 7:iy + 8, ix - 7:ix + 8] = (
            POSE_KPT_COLORS[k][::-1] * 255).astype(np.uint8)
        gt.append((kx, ky))
    return frame, np.asarray(gt)


class OcclusionRelayClip:
    """Long occlusion-heavy benchmark sequence for sequence-level
    StrongSORT quality rows (BASELINE.md; SURVEY.md H1-H4 parity).

    Two relays of the measured occlusion-bounce mechanic from the JAX
    package's tests/test_reid_quality.py (geometry tuned there so that
    during each blind window the constant-velocity KF predictions CROSS and
    motion-only association strictly prefers the swapped pairing):

    - pair A (ids 1, 2; bright-at-bottom / bright-at-top gradient
      squares) runs ``cycles`` hide-bounce-re-emerge periods behind the
      static wall (id 3), then leaves the scene;
    - pair B (ids 4, 5; same mechanic, shifted shade levels) enters
      after a gap and runs ``cycles`` more periods.

    Every period is one identity-swap opportunity for a motion-only
    tracker; the appearance term must win them all. 2*cycles events
    over ~60*2*cycles+gap frames.

    ``pan_amp`` > 0 adds a smooth global camera pan (whole scene +
    static noise background shifted by an integer-rounded Lissajous
    offset) — truth moves with the pan, so tracking it well requires
    camera-motion compensation (exercises gmc_method='flow_tpu' on
    real frames; the background is static noise so dense LK has
    texture to lock onto).
    """

    WALL = (116.0, 108.0, 204.0, 196.0)
    HIDE_PX = 16.0
    PERIOD = 60  # frames per hide-bounce-re-emerge cycle (tb = 30)

    def __init__(self, cycles: int = 2, gap: int = 70, size=(320, 320),
                 seed: int = 5, pan_amp: float = 0.0):
        # gap default 70 > the trackers' max_age=60 so pair A's coasted
        # tracks are dead before pair B enters at the same positions
        self.h, self.w = size
        self.cycles = cycles
        self.gap = gap
        self.pan_amp = float(pan_amp)
        self.t_a = cycles * self.PERIOD          # pair A active [0, t_a)
        self.t_b = self.t_a + gap                # pair B active [t_b, end)
        self.num_frames = self.t_b + cycles * self.PERIOD
        self.fps = 30.0
        self.box = 64.0
        # measured bounce geometry (test_reid_quality.BounceClip): both
        # hide at tmod=16, bounce at 30, re-emerge at 45; coasted
        # overshoot makes the swapped pairing strictly closer
        self.v = {1: 2.3, 2: -2.7, 4: 2.3, 5: -2.7}
        self.x0 = {1: 68.0 - 16 * 2.3, 2: 188.0 + 16 * 2.7,
                   4: 68.0 - 16 * 2.3, 5: 188.0 + 16 * 2.7}
        self.y = {1: 120.0, 2: 126.0, 4: 122.0, 5: 128.0}
        # within-pair gradient contrast is what appearance must resolve
        self.grad = {1: (0.4, 0.9), 2: (0.9, 0.4),
                     4: (0.3, 1.0), 5: (1.0, 0.3)}
        self._bg = (np.random.default_rng(seed)
                    .uniform(0, 0.3, (self.h, self.w, 3)) * 255
                    ).astype(np.uint8)

    def _active(self, tid: int, t: int) -> bool:
        return (t < self.t_a) if tid in (1, 2) else (t >= self.t_b)

    def _phase(self, tid: int, t: int) -> int:
        return t if tid in (1, 2) else t - self.t_b

    def _x(self, tid: int, t: int) -> float:
        tb = self.PERIOD // 2
        tri = tb - abs((self._phase(tid, t) % self.PERIOD) - tb)
        return self.x0[tid] + self.v[tid] * tri

    def pan(self, t: int) -> tuple[int, int]:
        a = self.pan_amp
        if a == 0.0:
            return 0, 0
        dx = int(round(a * np.sin(2 * np.pi * t / 75.0)))
        dy = int(round(0.6 * a * np.cos(2 * np.pi * t / 75.0)))
        return dx, dy

    def _hidden(self, tid: int, t: int) -> bool:
        x1 = self._x(tid, t)
        wx1, _, wx2, _ = self.WALL
        overlap = min(x1 + self.box, wx2) - max(x1, wx1)
        return overlap >= self.HIDE_PX

    def truth(self, t: int, include_hidden: bool = False):
        """include_hidden: keep fully-occluded objects in the ground
        truth (MOT17-style annotation through occlusion) — the protocol
        for the BASELINE.md sequence rows, where GSI's gap interpolation
        must earn TP rather than count as FP."""
        dx, dy = self.pan(t)
        rows = []
        for tid in (1, 2, 4, 5):
            if self._active(tid, t) and (
                include_hidden or not self._hidden(tid, t)
            ):
                x1, y1 = self._x(tid, t) + dx, self.y[tid] + dy
                rows.append((tid, x1, y1, x1 + self.box, y1 + self.box))
        wx1, wy1, wx2, wy2 = self.WALL
        rows.append((3, wx1 + dx, wy1 + dy, wx2 + dx, wy2 + dy))
        return rows

    def __iter__(self) -> Iterator[np.ndarray]:
        b = int(self.box)
        for t in range(self.num_frames):
            dx, dy = self.pan(t)
            frame = np.roll(self._bg, (dy, dx), axis=(0, 1)).copy()
            for tid in (1, 2, 4, 5):
                if not self._active(tid, t) or self._hidden(tid, t):
                    continue
                x1 = int(self._x(tid, t)) + dx
                y1 = int(self.y[tid]) + dy
                lo, hi = self.grad[tid]
                g = (np.linspace(lo, hi, b)[:, None, None] * 255)
                frame[y1:y1 + b, x1:x1 + b] = g.astype(np.uint8)
            wx1, wy1, wx2, wy2 = (int(v) for v in self.WALL)
            frame[wy1 + dy:wy2 + dy, wx1 + dx:wx2 + dx] = int(0.66 * 255)
            yield frame
