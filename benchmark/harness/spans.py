"""The program's own spans in a device trace: the port's ``ssyt.`` spans
(``strongsort_yolo_tpu_torch/utils/profiling.StageTimers``, operator-scope
ranges of a running profiler, nested as one thread's are) and what the
traced slice holds inside each: its host seconds and count, the kernel
launches and host syncs issued while it was the innermost program span
open, and the device idle time charged to it. Every idle interval of the
slice (between the union of the device's kernels and copies, device-row
user annotations left out) is cut at the spans' edges, and each piece is
charged to the innermost program span open then, else to
``no program span``."""

from __future__ import annotations

import bisect

import torch

PREFIX = "ssyt."
NONE = "no program span"
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"})
SYNCS = frozenset({"cudaEventSynchronize", "cudaStreamSynchronize",
                   "cudaDeviceSynchronize", "cudaMemcpy"})


def _innermost(spans: list) -> list:
    """(start, end, name) ranges, nested -> sorted disjoint (start, end,
    name) pieces, each labelled with the innermost range open in it."""
    pieces, stack, t = [], [], None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if stack and a > t:
            pieces.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = a if t is None else max(t, a)
    close_until(float("inf"))
    return pieces


def split(events, t_start_us: float, t_stop_us: float) -> dict:
    """Profiler events (``prof.events()``: ``name``, ``device_type``,
    ``time_range`` in us) of a slice from ``t_start_us`` to ``t_stop_us``
    -> {span name: {"host_s", "count", "launches", "syncs", "idle_s"}},
    with ``NONE``'s launches, syncs and idle seconds besides."""
    dev, ranges, calls = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("bench.", PREFIX))):
                dev.append((a, b))
        elif e.name.startswith(PREFIX):
            ranges.append((a, b, e.name))
        elif e.name in LAUNCHES or e.name in SYNCS:
            calls.append((a, "launches" if e.name in LAUNCHES else "syncs"))
    out = {NONE: {"host_s": 0.0, "count": 0, "launches": 0, "syncs": 0,
                  "idle_s": 0.0}}
    for a, b, name in ranges:
        row = out.setdefault(name, {"host_s": 0.0, "count": 0, "launches": 0,
                                    "syncs": 0, "idle_s": 0.0})
        row["host_s"] += (b - a) / 1e6
        row["count"] += 1
    pieces = _innermost(ranges)
    starts = [p[0] for p in pieces]

    def at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t < pieces[i][1] else NONE

    for t, kind in calls:
        out[at(t)][kind] += 1
    dev.sort()
    busy = []
    for a, b in dev:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [[t_start_us, t_start_us]] + busy + [[t_stop_us, t_stop_us]]
    j = 0
    for prev, nxt in zip(edges, edges[1:]):
        a, b = max(prev[1], t_start_us), min(nxt[0], t_stop_us)
        if b <= a:
            continue
        charged = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name]["idle_s"] += part / 1e6
                charged += part
            k += 1
        out[NONE]["idle_s"] += (b - a - charged) / 1e6
    return out
