"""The split of a workload's tick by the program's own spans, on the card.

    python3 benchmark/tick_split.py --workload <name> --seed <n> [--seconds 20]

One process: the cell's set-up (as ``benchmark/run.py`` makes it), then
five windows of the app's overlapped loop on the same pipeline, one
JSON line each:

1. ``untraced``: host ms a tick of each ``ssyt.`` span
   (``Pipeline.spans``, reset at the window's start), their sum beside
   ``ssyt.tick`` and the harness's ``dispatch_ms`` beside that, the
   count wait, the frame ring's fill, and the crop slots a tick
   (``Pipeline.crop_slots``, ``crop_real``);
2. ``traced``: the profiler over a steady slice, as ``--trace 1`` takes
   it: for each span per traced tick its host ms, kernel launches, host
   syncs and the device idle ms charged to it (``harness/spans.split``),
   ``device_idle``, K4's and K6's device ms a tick and their shares of
   their rooflines at the window's mean padded G (K4: ``k4_bytes`` over
   the ring's tick arrays; K6: ``k6_ops`` at the bf16 peak);
3. ``traced_no_ranges``, ``traced_again``, ``traced_no_ranges_again``:
   traced with the spans' profiler ranges off, on and off, so that the
   traced ticks' ``dispatch_ms`` with and without them, in turns, gives
   the ranges' cost; and ``span_cost_us``, one empty span's host cost
   with no profiler and under one with and without its range.

Nothing here enters the benchmark's result line. The card's name and
power limit are the first line."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

TICK = "ssyt.tick"
OUTSIDE_TICK = ("ssyt.tick", "ssyt.materialize")
K4, K6 = ("banded_crop_kernel",), ("os_stage",)


def k6_ops(reid_model, crop_hw) -> float:
    """Operations of one crop through the OSNet stages K6 runs: two per
    multiply-add of every conv after the stem (the three stages' blocks,
    their transitions and conv5), counted on the reference's layer
    shapes."""
    import torch

    from reference.nn import Opts

    macs = []
    P = {sp.key: torch.empty(sp.shape, device="meta") for sp in reid_model.specs()}
    reid_model(P, torch.empty((1, 3, *crop_hw), device="meta"), Opts(macs=macs))
    return 2.0 * sum(macs[1:])  # macs[0]: the stem, a library conv


def k4_bytes(pipe, frames, det) -> tuple[int, int]:
    """-> (bytes K4 must move for one tick's packed slots, the slots G):
    the 32-byte sectors of the pyramid stack that hold a pixel some
    slot's taps weigh above zero, each read once however many slots
    share it, the slot parameters and the (G, 3, h, w) crops written
    once (``chip_smoke.k4_bytes``'s count)."""
    import torch

    from harness.roofline import SECTOR
    from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import _axis_taps

    slots = pipe.embed_slots(det.count.cpu().numpy())
    pyr = pipe.pyramid(frames)
    scal, ints, slot_frame = pipe.crop_params(
        pyr, det, torch.from_numpy(slots).to(frames.device))
    oh, ow = pipe.reid.cfg.crop_hw
    s, c, sum_h, width = pyr.stack.shape
    dt, elem = pyr.stack.dtype, pyr.stack.element_size()
    y_lo, y_hi, _, wy1 = _axis_taps(scal[:, 0], scal[:, 1], oh, scal[:, 4], dt)
    x_lo, x_hi, _, wx1 = _axis_taps(scal[:, 2], scal[:, 3], ow, scal[:, 5], dt)
    # a lo tap always weighs above zero: it stands in for a hi tap of 0
    rows = torch.cat([y_lo, torch.where(wy1 != 0, y_hi, y_lo)], 1)
    rows = rows + pyr.row_off.long()[ints[:, 2].long()][:, None]
    cols = torch.cat([x_lo, torch.where(wx1 != 0, x_hi, x_lo)], 1)
    touched = torch.zeros((s, sum_h, width), dtype=torch.bool, device=frames.device)
    touched[slot_frame.long()[:, None, None], rows[:, :, None], cols[:, None, :]] = True
    sectors = int(touched.reshape(-1, SECTOR // elem).any(-1).sum()) * SECTOR
    params = sum(t.numel() * t.element_size() for t in (pyr.row_off, scal, ints, slot_frame))
    g = slots.shape[1]
    return c * sectors + params + g * c * oh * ow * elem, g


def span_cost_us(n: int = 20000) -> dict:
    """Host us of one empty span: with no profiler, and under a profiler
    with its range and without (the module's ``_Record`` taken away)."""
    from torch.profiler import ProfilerActivity, profile

    from strongsort_yolo_tpu_torch.utils import profiling
    from strongsort_yolo_tpu_torch.utils.profiling import StageTimers

    def timed():
        t, t0 = StageTimers(), time.perf_counter()
        for _ in range(n):
            with t.stage("ssyt.cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    out = {"no_profiler": timed()}
    record = profiling._Record
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["profiler_range"] = timed()
        try:
            profiling._Record = None
            out["profiler_no_range"] = timed()
        finally:
            profiling._Record = record
    return out


def kernel_s(red, needles) -> float:
    return sum(sec for name, (sec, _) in red["kernels"].items()
               if any(n in name for n in needles))


def window(bp, pipe, ticks, k0, seconds, period, traced):
    """One window from tick ``k0`` -> (the Drive, the Slice or None, the
    traced ticks' ``dispatch_ms``)."""
    from harness import loop, trace

    pipe.spans.reset()
    pipe.crop_slots = pipe.crop_real = 0
    pipe.count_waits, pipe.count_wait_ms = 0, 0.0
    sl = trace.Slice() if traced else None
    t_lo, trace_ticks, marks = 0.35 * seconds, max(int(0.2 * seconds / period), 8), {}

    def on_tick(d, elapsed):  # the slice of harness/cell.run_cell
        if sl is None:
            return
        if sl.prof is None and elapsed >= t_lo:
            sl.start()
            marks["from"] = d.dispatched
        elif sl.running and d.dispatched - marks["from"] >= trace_ticks:
            sl.stop()

    win = loop.drive(bp, ticks, k0, seconds=seconds, on_tick=on_tick)
    if sl is not None and sl.running:
        sl.stop()
    first = marks.get("from", 0)
    return win, sl, win.dispatch_ms[first:first + trace_ticks] if traced else []


def host_split(pipe, win, streams: int) -> dict:
    import numpy as np

    sp, n = pipe.spans, pipe.spans.count[TICK]
    per_tick = {name: 1e3 * sp.total[name] / n for name in sorted(sp.total)}
    children = sum(v for name, v in per_tick.items() if name not in OUTSIDE_TICK)
    return {"ticks": n, "dispatch_ms": float(np.mean(win.dispatch_ms)),
            "tick_ms": per_tick[TICK], "children_ms": children,
            "children_share_of_tick": children / per_tick[TICK],
            "tick_over_dispatch": per_tick[TICK] / float(np.mean(win.dispatch_ms)),
            "span_ms": per_tick,
            "fill_ms": float(np.mean(win.fill_ms)) if win.fill_ms else None,
            "count_wait_ms": pipe.count_wait_ms / max(pipe.count_waits, 1),
            "crop_slots": pipe.crop_slots / n, "crop_real": pipe.crop_real / n,
            "stream_fps": streams * win.completed / (win.t1 - win.t0)}


def traced_split(sl, slots_per_tick, k4_per_slot, k6_per_crop) -> dict:
    from harness import roofline, spans, trace

    red = trace.reduce(sl)
    got = spans.split(sl.prof.events(), sl.t_start_us, sl.t_stop_us)
    n = got[TICK]["count"]
    rows = {name: {"host_ms": 1e3 * r["host_s"] / n, "launches": r["launches"] / n,
                   "syncs": r["syncs"] / n, "idle_ms": 1e3 * r["idle_s"] / n}
            for name, r in sorted(got.items())}
    k4_s = kernel_s(red, K4) / n
    k6_s = kernel_s(red, K6) / n
    out = {"traced_ticks": n, "window_s": red["window_s"],
           "device_idle": 100.0 * (1.0 - red["busy_s"] / red["window_s"]),
           "idle_ms": sum(r["idle_ms"] for r in rows.values()),
           "host_syncs": sum(r["syncs"] for name, r in rows.items()
                             if name != spans.NONE),
           "fill_idle_ms": sum(r["idle_ms"] for name, r in rows.items()
                               if name.startswith("ssyt.ring.")),
           "track_launches": rows.get("ssyt.track", {}).get("launches"),
           "k4_ms": 1e3 * k4_s, "k6_ms": 1e3 * k6_s, "spans": rows,
           "device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"],
           "program_span_in_device_ops": any(name.startswith(("ssyt.", "bench."))
                                             for name, _ in red["device_ops"])}
    if k4_s > 0:
        out["k4_roofline"] = 100.0 * roofline.bound_s(
            k4_per_slot * slots_per_tick, 0.0) / k4_s
    if k6_s > 0:
        out["k6_roofline"] = 100.0 * roofline.bound_s(
            0.0, k6_per_crop * slots_per_tick, "bf16") / k6_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch

    from harness import cell as cell_mod
    from harness import program, scenes, spans, trace
    from strongsort_yolo_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("tick_split needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    c = cell_mod.Cell(args.workload, ROOT)
    dev = torch.device("cuda")
    ticks = scenes.render(c.mix, args.seed, dev)
    _, P_det, reid_model, P_reid = cell_mod.make_weights(c.cfg, c.mix, args.seed,
                                                         ticks[0], dev)
    pipe = program.build(c.cfg, P_det, P_reid, dev)
    s, hw = int(c.mix["streams"]), tuple(c.mix["frame_hw"])
    bp = pipe.track_batch_prepare(s, hw)
    with program.Recorder(pipe) as rec:
        k, period, _ = cell_mod.warm_up(bp, ticks, rec, {}, True, True)
    nbytes = slots = 0
    for frames in ticks:  # K4's bytes a slot over the ring's tick arrays
        f = torch.from_numpy(frames).to(dev)
        with torch.no_grad():
            b, g = k4_bytes(pipe, f, pipe.detect(f))
        nbytes, slots = nbytes + b, slots + g
    k4_per_slot = nbytes / max(slots, 1)
    k6_per_crop = k6_ops(reid_model, pipe.reid.cfg.crop_hw)
    record = profiling._Record
    try:
        for name, traced, ranges in (("untraced", False, True), ("traced", True, True),
                                     ("traced_no_ranges", True, False),
                                     ("traced_again", True, True),
                                     ("traced_no_ranges_again", True, False)):
            profiling._Record = record if ranges else None
            win, sl, traced_ms = window(bp, pipe, ticks, k, args.seconds, period,
                                        traced)
            k += win.dispatched
            line = {"window": name, "workload": args.workload, "seed": args.seed,
                    "host": host_split(pipe, win, s)}
            if sl is not None and ranges:
                line["trace"] = traced_split(sl, line["host"]["crop_slots"],
                                             k4_per_slot, k6_per_crop)
            elif sl is not None:  # the profiler alone: no program range in it
                red = trace.reduce(sl)
                line["trace"] = {
                    "window_s": red["window_s"],
                    "device_idle": 100.0 * (1.0 - red["busy_s"] / red["window_s"]),
                    "program_ranges": sum(e.name.startswith(spans.PREFIX)
                                          for e in sl.prof.events())}
            if traced_ms:
                line["trace"]["dispatch_ms"] = sum(traced_ms) / len(traced_ms)
            line["k4_bytes_per_slot"] = k4_per_slot
            line["k6_ops_per_crop"] = k6_per_crop
            print(json.dumps(line), flush=True)
            del sl  # the next window runs without this trace's objects
            gc.collect()
    finally:  # the ranges back on
        profiling._Record = record
    print(json.dumps({"span_cost_us": span_cost_us()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
