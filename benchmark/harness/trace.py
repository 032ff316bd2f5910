"""The device trace of a steady slice of the window: ``torch.profiler``
over CPU and CUDA activity, reduced to the device's busy time (the
union of the kernels' and copies' spans, all streams together), time
and launches by kernel name, and the longest idle gaps, each named by
what the host was doing at its middle (the innermost host span open
then)."""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import ProfilerActivity, profile


class Slice:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.ticks = 0

    def start(self) -> None:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def warm(self, fn) -> None:
        """Profile ``fn()`` and drop the trace: the first start of a
        profiler in a process initialises the device tracer, seconds
        that a slice inside the window must not pay."""
        self.start()
        fn()
        self.stop()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 == 0.0


def reduce(sl: Slice) -> dict:
    """-> {"window_s", "busy_s", "kernels": {name: [seconds, count]},
    "device_ops": top 10 [name, seconds], "idle_gaps": top 10 [host
    span, seconds]}; None where the trace holds no device time."""
    dev_spans, kernels, host = [], {}, []
    for e in sl.prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith("bench."):  # a host span's mirror on the GPU row
                continue
            dev_spans.append((a, b))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (b - a) / 1e6
            k[1] += 1
        else:
            host.append((a, b, e.name))
    if not dev_spans:
        return None
    host_spans = [(a, b) for a, b, name in host if name.startswith("bench.")]
    sl.t_start_us = min(a for a, _ in host_spans) if host_spans else dev_spans[0][0]
    sl.t_stop_us = max(b for _, b in host_spans) if host_spans else dev_spans[-1][1]
    dev_spans.sort()
    merged = []
    for a, b in dev_spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    edges = [[sl.t_start_us, sl.t_start_us]] + merged + [[sl.t_stop_us, sl.t_stop_us]]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(edges, edges[1:])
                   if b[0] > a[1]), reverse=True)[:10]
    idle = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        covering = [(e - s, name) for s, e, name in host if s <= mid <= e]
        label = min(covering)[1] if covering else "no host span"
        outer = [name for s, e, name in host
                 if s <= mid <= e and name.startswith("bench.")]
        if outer and outer[0] != label:
            label = f"{outer[0]} > {label}"
        idle.append([label, length / 1e6])
    ops = sorted(([name, v[0]] for name, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    return {"window_s": sl.t1 - sl.t0, "busy_s": busy, "kernels": kernels,
            "device_ops": ops, "idle_gaps": idle}


def finite(v) -> bool:
    return v is not None and math.isfinite(v)
