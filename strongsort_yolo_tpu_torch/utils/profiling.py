"""Stage timers: the app's and the pipeline's one span recorder.

``StageTimers`` accumulates the host time of named spans (the app's
decode, dispatch, infer_track, analytics, draw, encode; the pipeline's
``ssyt.<layer>[.<part>]`` spans of a tick) with summary stats; its
summary and report are those of
``strongsort_yolo_tpu/utils/profiling.StageTimers``.

While a ``torch.profiler`` runs, each span is also a range in its trace,
on the profiler's clock and with the kernels launched inside it
correlated to it: an operator-scope record (``_RecordFunctionFast``),
which, unlike ``record_function``'s user annotation, leaves no mirror on
the trace's GPU row, so the device rows hold kernels and copies alone.
A span given a tick number carries it as the keyword input ``tick``
(recorded where the profiler records inputs, ``record_shapes=True``).
With no profiler a span costs a flag check and two clock reads.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

# PyTorch's operator-scope record; where a build lacks it, spans are timed
# and open no range
_Record = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class _Stage:
    """One span of a :class:`StageTimers` (its ``stage``)."""

    __slots__ = ("timers", "name", "tick", "t0", "record")

    def __init__(self, timers: StageTimers, name: str, tick: int | None):
        self.timers, self.name, self.tick = timers, name, tick

    def __enter__(self):
        self.record = None
        if _Record is not None and _autograd_profiler._is_profiler_enabled:
            self.record = (_Record(self.name) if self.tick is None
                           else _Record(self.name, [], {"tick": self.tick}))
            self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.record is not None:
            self.record.__exit__(*exc)
        self.timers.total[self.name] += dt
        self.timers.count[self.name] += 1
        return False


class StageTimers:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def stage(self, name: str, tick: int | None = None) -> _Stage:
        """A context manager: the enclosed span's host time, added to
        ``name``'s total and count on exit; a range of that name (with
        ``tick``) in a running profiler's trace."""
        return _Stage(self, name, tick)

    def reset(self) -> None:
        """Forget every span so far (the recorder stays the same object)."""
        self.total.clear()
        self.count.clear()

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name in self.total:
            n = max(self.count[name], 1)
            out[name] = {
                "total_s": round(self.total[name], 4),
                "count": self.count[name],
                "mean_ms": round(self.total[name] / n * 1000, 3),
            }
        return out

    def report(self) -> str:
        rows = sorted(
            self.summary().items(), key=lambda kv: -kv[1]["total_s"]
        )
        return "\n".join(
            f"{name:>12}: {s['mean_ms']:8.3f} ms/it x {s['count']}"
            for name, s in rows
        )
