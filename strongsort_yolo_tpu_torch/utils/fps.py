"""FPS meter (reference F8): wall clock over 10-frame windows
(the reference's ``yolo_multi_model.py:266-268, 320-328``).

Counterpart of ``strongsort_yolo_tpu/utils/fps.py``, kept as it is.
"""

from __future__ import annotations

import time


class FpsMeter:
    def __init__(self, window: int = 10):
        self.window = window
        self._start = time.time()
        self._frames = 0
        self.text = ""
        self.value = 0.0

    def tick(self) -> str:
        self._frames += 1
        if self._frames % self.window == 0:
            now = time.time()
            elapsed = max(now - self._start, 1e-9)
            self.value = self.window / elapsed
            self.text = f"FPS: {self.value:.2f}"
            self._start = now
        return self.text
