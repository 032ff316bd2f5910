"""Stage timers and a device trace of the app.

- ``StageTimers``: named per-stage wall-clock accumulators (decode,
  dispatch, infer_track, analytics, draw, encode) with summary stats;
  counterpart of ``strongsort_yolo_tpu/utils/profiling.StageTimers``,
  kept as it is;
- ``trace()``: a ``torch.profiler`` capture (CPU and CUDA activity)
  around any span, written as a Chrome trace, where the JAX package
  wraps ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimers:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

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


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("output", "torch_trace")):
    """Capture a torch.profiler trace (CPU, and CUDA where a card is
    present) around the enclosed span; on exit it is written to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto). Yields the
    profiler, whose ``key_averages()`` tables the span's ops."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
