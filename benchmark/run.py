"""The benchmark of the PyTorch + CUDA port (``strongsort_yolo_tpu_torch``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one workload of ``BENCHMARK.json`` on the CUDA device it is started
on: synthetic 1080p camera streams and weights made from ``--seed``,
set-up (the kernels' build on a checkout's first run, the weights, a
warm-up of every shape), then ``--seconds`` of the app's overlapped loop
over ``Pipeline.track_batch_prepare``'s ``BatchedPipeline``. With
``--trace 0`` the result carries the workload's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a device trace of a steady slice
of the window. Either way the plain reference (``benchmark/reference``)
then recomputes a sample of the window's ticks and decides ``correct``;
every number compared is printed beside its limit, last on standard
error and last in the result, the last line of standard output."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:  # the program's package, after the harness's own
    sys.path.insert(1, ROOT)

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness.cell import Cell, run_cell

    cell = Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, _, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, device="cuda")
    for name, c in result["checks"].items():
        bound = (f">= {c['min']}" if "min" in c else f"<= {c['limit']}")
        print(f"check {name} {c['value']!r} {bound}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
