"""Trajectory trail memory (reference F6).

``tracking_trajectories`` in the reference is a global
``{track_id: deque(maxlen=5)}`` of box centroids, pruned when an id
leaves the frame (``yolo_multi_model.py:28,45-47,100-109``). Here it is
per stream but keeps the same 5-point trails. Counterpart of
``strongsort_yolo_tpu/utils/trajectories.py``, kept as it is.
"""

from __future__ import annotations

from collections import deque


class TrajectoryMemory:
    def __init__(self, maxlen: int = 5):
        self.maxlen = maxlen
        self.trails: dict[int, deque] = {}

    def update(self, boxes) -> None:
        if boxes is None or boxes.id is None:
            self.trails.clear()
            return
        current = {int(i) for i in boxes.id}
        for tid in list(self.trails):
            if tid not in current:
                del self.trails[tid]
        for i in range(len(boxes)):
            tid = int(boxes.id[i])
            x1, y1, x2, y2 = boxes.xyxy[i]
            c = ((x1 + x2) / 2.0, (y1 + y2) / 2.0)
            self.trails.setdefault(tid, deque(maxlen=self.maxlen)).append(c)

    def items(self):
        return self.trails.items()
