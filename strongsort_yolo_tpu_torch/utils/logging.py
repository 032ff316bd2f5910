"""JSON-lines event log of the app (stream_start, resume, checkpoint,
frame_error, stream_end, stream_failed, group_failed): one dict and one
write per event. Counterpart of ``strongsort_yolo_tpu/utils/logging.py``,
kept as it is."""

from __future__ import annotations

import json
import os
import time


class EventLogger:
    def __init__(self, path: str | None = None, stream=None):
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        self._stream = stream

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(rec, default=str)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._stream:
            print(line, file=self._stream)

    def close(self):
        if self._fh:
            self._fh.close()


NULL_LOGGER = EventLogger()
