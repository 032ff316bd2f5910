"""Readings of the check's numbers, from which the limits are set: the
program's, over many seeds, and the control's (the reference in a lower
precision in the program's place: int8 round trips in the detector and
OSNet, bfloat16 in the LK and the tracker), on the same sampled ticks.

    python3 benchmark/readings.py --workload <name> --seconds <s> \\
        --seeds <n> ... [--control-seeds <k>]

One process runs every seed (set-up, a short window at the cell's own
load, the check); one JSON line a seed. The benchmark's own runs never
run the control."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from harness.cell import Cell, run_cell

    cell = Cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        result, numbers, controls = run_cell(
            cell, seed, args.seconds, False, t_start=t0, device="cuda",
            control=i < args.control_seeds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": numbers, "control": controls,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
