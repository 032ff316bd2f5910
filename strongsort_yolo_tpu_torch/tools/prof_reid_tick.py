"""Time the fused StrongSORT + OSNet tick on a CUDA device.

    python -m strongsort_yolo_tpu_torch.tools.prof_reid_tick
        [--variant osnet_x1_0] [--dtype f32|bf16] [--rounds 2]

chip_smoke.py's b-x1_0 path: S=8 streams of its synthetic 1080p frames
(``chip_smoke.make_frames``), yolov8n at 640 in the dtype (``half`` =
bf16), StrongSORT (gmc none) with the fused OSNet of the variant (seeded
random weights, ``reid_fused=True``: K6 three times a tick), the class
bias calibrated as chip_smoke calibrates it; each round drives
``chip_smoke.WIDE_TICKS`` ticks through ``BatchedPipeline.step`` and
prints K6's launches, G per tick and the ms a tick (host clock around a
synchronised step; the median of the ticks after the first two, as
chip_smoke reports it). It takes chip_smoke.py from the repository root
beside the package, and the package from ``sys.path``, so it also times
an older checkout's package: run this file with that checkout on
``PYTHONPATH``. Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="prof_reid_tick")
    ap.add_argument("--variant", default="osnet_x1_0")
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prof_reid_tick: no CUDA device", file=sys.stderr)
        return 1
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import chip_smoke as cs
    from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import os_stage
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    h, w = 1080, 1920
    pool = cs.make_frames(h, w, seed=1)
    pipe = cs._main_pipeline(StrongSortConfig(gmc_method="none"), pool,
                             fused=True, reid=args.variant,
                             half=args.dtype == "bf16")
    slots = cs._record_slots(pipe)
    for r in range(args.rounds):
        ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(cs.S_MAIN)])
                 for t in range(cs.WIDE_TICKS)]
        counts, times, _ = cs._drive(BatchedPipeline(pipe, cs.S_MAIN, (h, w)),
                                     ticks, [os_stage])
        print(f"{args.variant} {args.dtype} S={cs.S_MAIN} 1080p, round {r}: K6 "
              f"launches {counts['os_stage']}, G per tick {slots[-cs.WIDE_TICKS:]}, "
              f"ms/tick {cs._ms_line(times)} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
