"""Frame annotation in the reference's visual style, on the host.

Counterpart of ``strongsort_yolo_tpu/media/annotator.py``, kept as it is
(``yolo_multi_model.py`` of the reference):
- red (0,0,225) box with dark label chip ``ID: <id> <name> <conf>%``;
- green/black keypoint dots with red index text, invisible keypoints
  skipped;
- blue polygon outline + 0.5-alpha class-color fill for masks, with a
  seeded color LUT;
- white 5-point trajectory trails;
- black count-dict overlay at 0.7 blend;
- red FPS text top-left.

Backends: ``Annotator`` draws with cv2; ``NativeAnnotator`` with the C++
shim (``media/native.py``), same call surface, no OpenCV.
``make_annotator(backend="auto")`` takes cv2 where it imports, else the
shim.
"""

from __future__ import annotations

import numpy as np


def class_colors(n: int = 80, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(n, 3), dtype=np.uint8)


def make_annotator(names, seed: int = 0, backend: str = "auto"):
    """backend: 'cv2' (reference-exact visuals), 'native' (C++ shim,
    no OpenCV needed), or 'auto' (cv2 if importable else native)."""
    if backend == "auto":
        try:
            import cv2  # noqa: F401

            backend = "cv2"
        except ImportError:
            backend = "native"
    if backend == "native":
        return NativeAnnotator(names, seed)
    return Annotator(names, seed)


class Annotator:
    def __init__(self, names: dict[int, str], seed: int = 0):
        self.names = names
        self.colors = class_colors(max(len(names), 80), seed)

    def draw_results(self, frame: np.ndarray, results) -> np.ndarray:
        """Draw one frame's Results (track or predict mode) in the
        reference's visual style. Returns the annotated frame (masks
        rebind the buffer, as in the reference :117-121)."""
        import cv2

        boxes = results.boxes
        if boxes is None or len(boxes) == 0:
            return frame

        if results.masks is not None:
            for i, poly in enumerate(results.masks.xy):
                if len(poly) < 3:
                    continue
                pts = np.int32(poly)
                cv2.polylines(frame, [pts], True, (255, 0, 0), thickness=2)
                cls = int(boxes.cls[i]) if i < len(boxes) else 0
                color = [int(c) for c in self.colors[cls % len(self.colors)]]
                overlay = frame.copy()
                cv2.fillPoly(overlay, [pts], color)
                frame = cv2.addWeighted(frame, 0.5, overlay, 0.5, 0)

        if results.keypoints is not None:
            kxy = results.keypoints.xy
            kconf = results.keypoints.conf
            for det in range(len(kxy)):
                for idx in range(kxy.shape[1]):
                    x, y = kxy[det, idx]
                    if kconf[det, idx] < 0.5 or (x, y) == (0.0, 0.0):
                        continue
                    cv2.circle(frame, (int(x), int(y)), 5, (0, 255, 0), -1)
                    cv2.circle(frame, (int(x), int(y)), 2, (0, 0, 0), -1)
                    cv2.putText(
                        frame, str(idx), (int(x) + 5, int(y) - 5),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 255), 1,
                        cv2.LINE_AA,
                    )

        for i in range(len(boxes)):
            x1, y1, x2, y2 = (int(v) for v in boxes.xyxy[i])
            conf = float(boxes.conf[i])
            cls = int(boxes.cls[i])
            name = self.names.get(cls, str(cls))
            cv2.rectangle(frame, (x1, y1), (x2, y2), (0, 0, 225), 2)
            if boxes.id is not None:
                label = f" ID: {int(boxes.id[i])} {name} {round(conf * 100, 1)}%"
            else:
                label = f" {name} {round(conf * 100, 1)}%"
            (tw, th), baseline = cv2.getTextSize(
                label, cv2.FONT_HERSHEY_SIMPLEX, 2, 1
            )
            cv2.rectangle(
                frame, (x1, y1), ((x1 + tw // 3) - 20, y1 - th + baseline),
                (30, 30, 30), cv2.FILLED,
            )
            cv2.putText(
                frame, label, (x1, y1 - 7), cv2.FONT_HERSHEY_SIMPLEX,
                0.5, (255, 255, 255), 1,
            )
        return frame

    def draw_trails(self, frame: np.ndarray, trails) -> None:
        import cv2

        for _, trail in trails.items():
            pts = list(trail)
            for i in range(1, len(pts)):
                cv2.line(
                    frame,
                    (int(pts[i - 1][0]), int(pts[i - 1][1])),
                    (int(pts[i][0]), int(pts[i][1])),
                    (255, 255, 255), 2,
                )

    def draw_counts(self, frame: np.ndarray, counts: dict[str, int]) -> np.ndarray:
        import cv2

        display = frame.copy()
        text = "{}".format(counts)
        (tw, _), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1)
        cv2.rectangle(frame, (10, 11), (tw * 2, 70), (0, 0, 0), -1)
        cv2.putText(
            frame, text, (20, 45), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
            (210, 210, 210), 2,
        )
        return cv2.addWeighted(frame, 0.7, display, 0.3, 0)

    def draw_count_line(self, frame: np.ndarray, line, totals) -> None:
        """Yellow count line + 'in N  out M' tallies at its midpoint
        (--count-line overlay; directional line-cross counting)."""
        import cv2

        x1, y1, x2, y2 = (int(v) for v in line)
        cv2.line(frame, (x1, y1), (x2, y2), (0, 255, 255), 2)
        n_in, n_out = totals
        mx, my = (x1 + x2) // 2, (y1 + y2) // 2
        cv2.putText(
            frame, f"in {n_in}  out {n_out}", (mx + 6, my - 6),
            cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 255), 2, cv2.LINE_AA,
        )

    def draw_fps(self, frame: np.ndarray, fps_text: str) -> None:
        import cv2

        cv2.putText(
            frame, fps_text, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
            (0, 0, 255), 1, cv2.LINE_AA,
        )


class NativeAnnotator:
    """Same surface as Annotator, drawn by the C++ media shim
    (native/media_shim.cpp) — no OpenCV dependency. Visual style
    matches the reference's layout; the text font is the shim's
    bitmap font rather than Hershey."""

    def __init__(self, names: dict[int, str], seed: int = 0):
        from strongsort_yolo_tpu_torch.media import native

        if not native.available():
            raise RuntimeError(
                "native media shim unavailable: " + str(native.build_error))
        self.native = native
        self.names = names
        self.colors = class_colors(max(len(names), 80), seed)

    def draw_results(self, frame: np.ndarray, results) -> np.ndarray:
        nat = self.native
        boxes = results.boxes
        if boxes is None or len(boxes) == 0:
            return frame

        if results.masks is not None:
            for i, poly in enumerate(results.masks.xy):
                if len(poly) < 3:
                    continue
                nat.draw_polyline(frame, poly, (255, 0, 0), 2, closed=True)
                cls = int(boxes.cls[i]) if i < len(boxes) else 0
                color = self.colors[cls % len(self.colors)]
                overlay = frame.copy()
                nat.fill_poly(overlay, poly, color)
                nat.blend(frame, overlay, 0.5, 0.5)

        if results.keypoints is not None:
            kxy = results.keypoints.xy
            kconf = results.keypoints.conf
            for det in range(len(kxy)):
                for idx in range(kxy.shape[1]):
                    x, y = kxy[det, idx]
                    if kconf[det, idx] < 0.5 or (x, y) == (0.0, 0.0):
                        continue
                    nat.draw_rect(frame, int(x) - 3, int(y) - 3,
                                  int(x) + 3, int(y) + 3, (0, 255, 0), -1)
                    nat.draw_rect(frame, int(x) - 1, int(y) - 1,
                                  int(x) + 1, int(y) + 1, (0, 0, 0), -1)
                    nat.draw_text(frame, str(idx), int(x) + 5, int(y) - 12,
                                  (0, 0, 255))

        for i in range(len(boxes)):
            x1, y1, x2, y2 = (int(v) for v in boxes.xyxy[i])
            conf = float(boxes.conf[i])
            cls = int(boxes.cls[i])
            name = self.names.get(cls, str(cls))
            nat.draw_rect(frame, x1, y1, x2, y2, (0, 0, 225), 2)
            if boxes.id is not None:
                label = f" ID: {int(boxes.id[i])} {name} {round(conf * 100, 1)}%"
            else:
                label = f" {name} {round(conf * 100, 1)}%"
            tw, th = nat.text_size(label)
            nat.draw_rect(frame, x1, y1 - th - 2, x1 + tw, y1, (30, 30, 30), -1)
            nat.draw_text(frame, label, x1, y1 - th - 1, (255, 255, 255))
        return frame

    def draw_trails(self, frame: np.ndarray, trails) -> None:
        for _, trail in trails.items():
            pts = list(trail)
            for i in range(1, len(pts)):
                self.native.draw_line(
                    frame, int(pts[i - 1][0]), int(pts[i - 1][1]),
                    int(pts[i][0]), int(pts[i][1]), (255, 255, 255), 2,
                )

    def draw_counts(self, frame: np.ndarray, counts: dict[str, int]) -> np.ndarray:
        display = frame.copy()
        text = "{}".format(counts)
        tw, _ = self.native.text_size(text)
        self.native.draw_rect(frame, 10, 11, max(tw * 2, 60), 70, (0, 0, 0), -1)
        self.native.draw_text(frame, text, 20, 32, (210, 210, 210))
        self.native.blend(frame, display, 0.7, 0.3)
        return frame

    def draw_count_line(self, frame: np.ndarray, line, totals) -> None:
        x1, y1, x2, y2 = (int(v) for v in line)
        self.native.draw_line(frame, x1, y1, x2, y2, (0, 255, 255), 2)
        n_in, n_out = totals
        mx, my = (x1 + x2) // 2, (y1 + y2) // 2
        self.native.draw_text(
            frame, f"in {n_in}  out {n_out}", mx + 6, my - 14, (0, 255, 255)
        )

    def draw_fps(self, frame: np.ndarray, fps_text: str) -> None:
        self.native.draw_text(frame, fps_text, 10, 17, (0, 0, 255))
