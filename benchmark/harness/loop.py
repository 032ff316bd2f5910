"""The measured loop: the app's overlapped loop over one BatchedPipeline,
closed, one tick in flight: ``step_async(t)``, then ``materialize(t -
1)``. A tick's latency runs from its ``step_async`` call (its due time
in a closed loop) to the return of its ``materialize``."""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from harness import scenes


class Drive:
    """Host counters of one stretch of the loop."""

    def __init__(self):
        self.latency_s: list[float] = []
        self.dispatch_ms: list[float] = []
        self.fill_ms: list[float] = []
        self.dispatched = 0
        self.completed = 0
        self.bad_frames = 0
        self.t0 = self.t1 = 0.0


def _finite(results) -> int:
    """Stream-frames of one tick whose Results are malformed."""
    return sum(0 if np.isfinite(r.boxes.xyxy).all() else 1 for r in results)


def drive(bp, ticks, k0: int, *, n: int | None = None, seconds: float | None = None,
          picks=frozenset(), recorder=None, caps=None, on_tick=None) -> Drive:
    """Ticks k0, k0 + 1, ... (frames ``ticks[scenes.order(k)]``) for ``n``
    ticks or until ``seconds`` have passed. A tick in ``picks`` leaves in
    ``caps[k]`` the program's state before and after it, its detections,
    embeddings, warps and, once materialized, its Results. The last tick
    is materialized after the stretch closes and counts as not completed
    in it. ``on_tick(d, elapsed_s)`` runs before each dispatch."""
    d = Drive()
    caps = {} if caps is None else caps
    ring = len(ticks)
    pending = None
    d.t0 = time.perf_counter()
    until = None if seconds is None else d.t0 + seconds
    k = k0
    while True:
        now = time.perf_counter()
        if (n is not None and k - k0 >= n) or (until is not None and now >= until):
            break
        if on_tick is not None:
            on_tick(d, now - d.t0)
        frames = ticks[scenes.order(k, ring)]
        pick = k in picks
        pre = bp.states if pick else None
        t_call = time.perf_counter()
        with record_function("bench.step_async"):
            handle = bp.step_async(frames)
        d.dispatch_ms.append((time.perf_counter() - t_call) * 1e3)
        if bp.ring is not None:  # None on the CPU: no pinned ring
            d.fill_ms.append(bp.ring.fill_ms)
        d.dispatched += 1
        if pick:
            caps[k] = {"pre": pre, "det": recorder.det, "feats": recorder.feats,
                       "nms": recorder.nms, "anchors": recorder.anchors,
                       "warps": bp.last_warps, "post": bp.states}
        if pending is not None:
            with record_function("bench.materialize"):
                res = bp.materialize(pending[0])
            d.latency_s.append(time.perf_counter() - pending[1])
            d.completed += 1
            d.bad_frames += _finite(res)
            if pending[2] in caps:
                caps[pending[2]]["results"] = res
        pending = (handle, t_call, k if pick else None)
        k += 1
    d.t1 = time.perf_counter()
    if pending is not None:
        res = bp.materialize(pending[0])
        d.bad_frames += _finite(res)
        if pending[2] in caps:
            caps[pending[2]]["results"] = res
    return d
