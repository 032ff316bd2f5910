"""MOT-style label file writer (reference F9).

The reference appends lines
``frameId cls trackId conf x1 y1 x2 y2 -1 -1 -1 -1`` to
``output/{video}_labels.txt`` (``yolo_multi_model.py:165-169``) with two
quirks:

- ``frameId`` is always 0 (the real counter is never passed in);
- the file is opened in append mode and never truncated across runs,
  so lines accumulate between invocations.

Both are reproduced behind ``compat=True``; the default writes real
frame ids and truncates per run. Counterpart of
``strongsort_yolo_tpu/utils/labels.py``, same format: coordinates
truncated by ``int()``, confidence rounded to 3 places.
"""

from __future__ import annotations

import os


class LabelWriter:
    def __init__(self, path: str, *, compat: bool = False, append: bool = False):
        """``append=True`` keeps existing lines (checkpoint/resume);
        default truncates per run unless ``compat``."""
        self.path = path
        self.compat = compat
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not compat and not append and os.path.exists(path):
            os.remove(path)
        self._fh = open(path, "a")

    def write_frame(self, frame_id: int, boxes) -> None:
        """boxes: a pipeline.Boxes with .id set (track mode only —
        predict mode writes nothing, as in the reference, where the
        write loop runs before the predict branch fills its boxes)."""
        if boxes is None or boxes.id is None:
            return
        fid = 0 if self.compat else frame_id
        for i in range(len(boxes)):
            x1, y1, x2, y2 = boxes.xyxy[i]
            line = (
                f"{fid} {int(boxes.cls[i])} {int(boxes.id[i])} "
                f"{round(float(boxes.conf[i]), 3)} "
                f"{int(x1)} {int(y1)} {int(x2)} {int(y2)} -1 -1 -1 -1\n"
            )
            self._fh.write(line)
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
