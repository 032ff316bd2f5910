"""Time K6, the fused OSNet stage, on a CUDA device.

    python -m strongsort_yolo_tpu_torch.tools.prof_k6 [--variants osnet_x1_0,...]
        [--g 96,...] [--dtype bf16|f32]

For each stage of each OSNet width (default: x0_5, x0_75 and x1_0; random
weights from ``init_osnet`` seed 1, as ``chip_smoke.check_k6``; seeded
crops) at each G (default 96), in bfloat16 (default) or float32: the form
the stage takes (``stage_form``), its device time by CUDA-graph replay
(``prof_conv.graph_ms``), the bound (2 x multiply-adds over 989 TFLOP/s in
bf16, over the CUDA cores' 67 TFLOP/s in f32, or the bytes in and out
over 3.35 TB/s) and the rate, in f32 also the share of the 3xTF32
ceiling (495 / 3 TFLOP/s); each output held against ``os_stage_plain``
(bf16: the mean |err| within 2e-4 of the largest output,
``chip_smoke.K6_BF16_MEAN``; f32: the max |err| within 1e-4) and two
launches bit-identical. Then each width's three stages summed.
The tool calls only K6 functions that every form of the package has, so
it also times an older checkout's K6: run this file with that checkout
on ``PYTHONPATH``. The last line is every row as one JSON object. Exits
nonzero without a CUDA device or when an output breaks the bar.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from strongsort_yolo_tpu_torch.models.osnet import (
    OsnetConfig, init_osnet, osnet_from_state_dict,
)
from strongsort_yolo_tpu_torch.ops.cuda import osnet_kernel as ok
from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

BAR = 2e-4  # mean |err| over the largest output (chip_smoke.K6_BF16_MEAN)
F32_BAR = 1e-4  # max |err| in float32
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# H100 SXM: bf16 tensor cores, dense; float32 on the CUDA cores
PEAK_PER_MS = {torch.bfloat16: 989e9, torch.float32: 67e9}
TF32X3_PER_MS = 495e9 / 3  # the 3xTF32 ceiling: three TF32 products each
HBM_BYTES_PER_MS = 3.35e9


def stage_macs(spec) -> int:
    """Multiply-adds of one crop through a stage: its two OS blocks
    (conv1, ten lite convs, four gates, conv3, the down conv where the
    widths differ) and the transition or conv5."""
    p, mid, ci, co = spec.h * spec.w, spec.mid, spec.c_in, spec.c_out
    lites = 10 * (p * mid * mid + 9 * p * mid)
    gates = 4 * 2 * mid * max(mid // 16, 1)
    block_a = p * mid * ci + lites + gates + p * co * mid + (
        p * co * ci if ci != co else 0)
    block_b = p * mid * co + lites + gates + p * co * mid
    return block_a + block_b + p * co * co


def profile_stage(model, i: int, spec, g: int, seed: int,
                  dtype=torch.bfloat16) -> dict:
    """One row: the stage at G crops in ``dtype``, as the wrapper runs
    it; ``good`` where it meets the dtype's bar against the plain
    version and two launches are bit-identical."""
    dev = torch.device("cuda")
    w = ok.stage_weights(model, i, dtype).to(dev)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (g, spec.c_in, spec.h, spec.w)).astype(np.float32)).to(
            dev, dtype)
    got, again = ok.os_stage(x, w, spec), ok.os_stage(x, w, spec)
    want = ok.os_stage_plain(x, w, spec)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    mean = float(diff.mean() / want.float().abs().max().clamp(min=1e-30))
    ms = graph_ms(lambda: ok.os_stage(x, w, spec), iters=5, warmup=1)
    flops = 2 * stage_macs(spec) * g
    nbytes = sum(t.numel() * t.element_size() for t in (x, got, w.mats, w.vecs))
    bound = max(flops / PEAK_PER_MS[dtype], nbytes / HBM_BYTES_PER_MS)
    repeatable = bool(torch.equal(got, again))
    good = repeatable and (mean <= BAR if dtype == torch.bfloat16
                           else float(diff.max()) <= F32_BAR)
    return dict(form=ok.stage_form(spec, dtype), g=g, ms=ms,
                bound_ms=bound, share=bound / ms, tflops=flops / ms / 1e9,
                tf32x3_share=flops / TF32X3_PER_MS / ms,
                mean_err=mean, max_err=float(diff.max()),
                repeatable=repeatable, good=good)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="prof_k6")
    ap.add_argument("--variants", default="osnet_x0_5,osnet_x0_75,osnet_x1_0")
    ap.add_argument("--g", default="96", help="crops per call, comma-separated")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    dtype = DTYPES[args.dtype]
    if not torch.cuda.is_available():
        print("prof_k6: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows, ok_all = [], True
    for variant in args.variants.split(","):
        cfg = OsnetConfig(variant=variant)
        model = osnet_from_state_dict(
            init_osnet(cfg, torch.Generator().manual_seed(1)), cfg)
        for g in (int(v) for v in args.g.split(",")):
            total = 0.0
            for i, spec in enumerate(ok.stage_specs(cfg.channels)):
                r = profile_stage(model, i, spec, g, seed=100 + i, dtype=dtype)
                r.update(variant=variant, stage=i + 2, dtype=args.dtype)
                rows.append(r)
                ok_all &= r["good"]
                total += r["ms"]
                ceiling = (f", {r['tf32x3_share']:.2%} of the 3xTF32 ceiling"
                           if dtype == torch.float32 else "")
                print(f"{variant} stage {i + 2} G={g} {args.dtype} ({r['form']}): "
                      f"{r['ms']:.4f} ms (graph replay), {r['tflops']:.2f} "
                      f"TFLOP/s, bound {r['bound_ms']:.4f} ms, {r['share']:.2%} "
                      f"of it{ceiling}; mean |err| {r['mean_err']:.3g} of the "
                      f"largest output, max {r['max_err']:.3g}, launches "
                      f"bit-identical {r['repeatable']}"
                      + ("" if r["good"] else " FAILS") + f" [{card}]", flush=True)
            print(f"{variant} three stages at G={g} {args.dtype}: {total:.4f} ms "
                  f"[{card}]", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
