"""One run of one cell: set-up, the measured window, the trace, the
check, and the result line."""

from __future__ import annotations

import copy
import gc
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

from harness import check, loop, program, scenes, trace, weights
from reference import detect as ref_detect

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
JAX_NAMES = ("jax", "jaxlib", "flax", "strongsort_yolo_tpu")
CHECKED_TICKS = 6  # window ticks the reference recomputes, drawn from the seed
WARM_PERIODS = 6  # at most this many ping-pong periods of warm-up past the first two rings


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, extra: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and traffic
    files, and the metrics it reports."""

    def __init__(self, name: str, root: str = ROOT, overrides: dict | None = None,
                 entry: dict | None = None):
        """``entry``: a workload that ``BENCHMARK.json`` does not list
        (its name, ``config``, ``traffic`` and ``chips``), its
        configuration in ``benchmark/configs/<config>.json``."""
        manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in manifest["workloads"]}
        if entry is None and name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.entry = entry or cells[name]
        self.name = name
        files = {c["name"]: c["file"] for c in manifest["configs"]}
        config = self.entry["config"]
        overrides = overrides or {}
        self.cfg = merge(load_json(os.path.join(
            root, files.get(config, os.path.join("benchmark", "configs", config + ".json")))),
            overrides.get("config"))
        self.mix = merge(load_json(os.path.join(root, "benchmark", "traffic",
                                                self.entry["traffic"] + ".json")),
                         overrides.get("traffic"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.entry["chips"])


def reference_models(cfg: dict):
    d = cfg["detector"]
    det = importlib.import_module("reference." + d["arch"]).Model(**d.get("arch_args", {}))
    reid = None
    if cfg.get("reid"):
        r = cfg["reid"]
        reid = importlib.import_module("reference." + r["arch"]).Model(
            r["variant"], r["feat_dim"])
    return det, reid


def make_weights(cfg: dict, mix: dict, seed: int, first_tick: np.ndarray, device):
    """The detector's weights with the head calibrated on ``first_tick``'s
    frames to about ``mix["candidates"]`` candidates a frame, and the ReID
    net's."""
    det, reid = reference_models(cfg)
    P_det = weights.make(det.specs(), weights.generator(seed, device, 1), device)
    d = cfg["detector"]
    ref_detect.calibrate_head(det, P_det, torch.from_numpy(first_tick).to(device),
                              d["imgsz"], d["conf"], int(mix["candidates"]))
    P_reid = (weights.make(reid.specs(), weights.generator(seed, device, 2), device)
              if reid is not None else None)
    return det, P_det, reid, P_reid


def jax_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(JAX_NAMES))


def per_layer_metrics(cell: Cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module("metrics." + m["name"])
        v = reader.read(ctx)
        if trace.finite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


class Context:
    """What a per-layer metric's reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _segments() -> int:
    """cudaMalloc calls of the caching allocator so far."""
    return int(torch.cuda.memory_stats().get("segment.all.allocated", 0))


def warm_up(bp, ticks, rec, caps, traced: bool, cuda: bool):
    """Set-up's ticks: every ring slot and frame twice, the first tick
    checked (a traced run starts the device tracer here, which takes
    seconds the first time), then whole ping-pong periods of the ring,
    each holding as many ticks' products as the window's check will,
    until one asks the allocator for no new memory (at most
    ``WARM_PERIODS``), so that the window does not. -> (the window's
    first tick, seconds a tick, the set-up's memory peak)."""
    ring = len(ticks)

    def first():
        loop.drive(bp, ticks, 0, n=ring, picks={0}, recorder=rec, caps=caps)

    trace.Slice().warm(first) if traced else first()
    warm = loop.drive(bp, ticks, ring, n=ring, recorder=rec)
    period = (warm.t1 - warm.t0) / max(warm.dispatched, 1)
    k = 2 * ring
    if cuda:
        full = max(2 * ring - 2, 1)
        for _ in range(WARM_PERIODS):
            torch.cuda.synchronize()
            before = _segments()
            held: dict = {}  # as many ticks held as the window's check holds
            loop.drive(bp, ticks, k, n=full, recorder=rec, caps=held,
                       picks=set(range(k, k + min(CHECKED_TICKS, full))))
            del held
            k += full
            torch.cuda.synchronize()
            if _segments() == before:
                break
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return k, period, setup_peak
    return k, period, 0


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *, t_start: float,
             device="cuda", hook=None, control: bool = False):
    """-> (result line, {number: value}, the control's {number: value}
    or None). ``hook(pipe, bp)`` runs after the program is built (tests
    break the program through it); ``control`` also puts the
    lower-precision reference in the program's place on the same ticks."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix = cell.cfg, cell.mix
    ticks = scenes.render(mix, seed, dev)
    ring = len(ticks)
    det_model, P_det, reid_model, P_reid = make_weights(cfg, mix, seed, ticks[0], dev)
    pipe = program.build(cfg, P_det, P_reid, dev)
    s, hw = int(mix["streams"]), tuple(mix["frame_hw"])
    bp = pipe.track_batch_prepare(s, hw)
    caps: dict = {}
    with program.Recorder(pipe) as rec:
        if hook is not None:
            hook(pipe, bp)
        k0, period, setup_peak = warm_up(bp, ticks, rec, caps, traced, cuda)
        n_est = max(int(0.4 * seconds / period), 1)
        rng = np.random.default_rng(int(seed) % 2**64)
        picks = set((k0 + rng.choice(n_est, min(CHECKED_TICKS, n_est),
                                     replace=False)).tolist())
        pipe.count_waits, pipe.count_wait_ms = 0, 0.0
        segments = _segments() if cuda else 0
        setup_s = time.perf_counter() - t_start

        sl = trace.Slice() if traced else None
        t_lo = 0.35 * seconds
        trace_ticks = max(int(0.2 * seconds / period), 8)  # a steady slice, by ticks
        marks = {}

        def on_tick(d, elapsed):
            if sl is None:
                return
            if sl.prof is None and elapsed >= t_lo:
                sl.start()
                marks["from"] = d.dispatched
            elif sl.running and d.dispatched - marks["from"] >= trace_ticks:
                sl.stop()

        win = loop.drive(bp, ticks, k0, seconds=seconds, picks=picks, recorder=rec,
                         caps=caps, on_tick=on_tick)
        if sl is not None and sl.running:
            sl.stop()
    window_s = win.t1 - win.t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:  # a diagnostic: device memory the window itself had to ask for
        print(f"allocator segments added in the window: {_segments() - segments}",
              file=sys.stderr)
    host = {"count_wait_ms": pipe.count_wait_ms, "count_waits": pipe.count_waits}
    found = jax_modules()
    if found:
        raise RuntimeError(f"JAX modules loaded by the run: {found}")
    del pipe, bp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    e2e = {"stream_fps": s * win.completed / window_s,
           "tick_p95_ms": (float(np.percentile(np.asarray(win.latency_s), 95)) * 1e3
                           if win.latency_s else float("nan")),
           "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(peak, setup_peak)) if cuda else 0}
    breakdown = None
    if not traced:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    else:
        red = trace.reduce(sl) if sl is not None and sl.prof is not None else None
        if red is not None:
            device_info["busy_s"] = red["busy_s"]
            device_info["window_s"] = red["window_s"]
            breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        ctx = Context(cfg=cfg, mix=mix, streams=s, frame_hw=hw, trace=red,
                      window=win, window_s=window_s, host=host,
                      det_model=det_model, roofline=importlib.import_module("harness.roofline"))
        metrics = per_layer_metrics(cell, ctx)

    t_check = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = check.Reference(cfg, det_model, P_det, reid_model, P_reid)
    numbers = check.compare(ref, caps, ticks, ring, dev)
    controls = check.compare(ref, caps, ticks, ring, dev, control=True) if control else None
    limits = cfg.get("limits", {})
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": v}
              for k, v in sorted(limits.items())}
    window_checked = sum(1 for k in caps if k >= k0)
    correct = (bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
               and window_checked > 0 and win.completed > 0 and win.bad_frames == 0)
    checks["window_ticks_checked"] = {"value": window_checked, "min": 1}
    print(f"the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": s * win.dispatched,
              "failed": win.bad_frames, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, numbers, controls
