"""Time K7, the fused conv + bias + SiLU, on a CUDA device, form by form.

    python -m strongsort_yolo_tpu_torch.tools.prof_conv [S ...]

Counterpart of ``tools/prof/_prof_conv.py`` and ``_prof_conv2.py`` (the
formulation shootout of the TPU kernel), at their shapes ``SHAPES``
(80x80 and 40x40 planes, k=3, the route's NCHW layout), for each batch S
given (default 32 and 8). Per shape and S it prints two rows, bfloat16
and float32, with the device time (CUDA events around the replay of a
CUDA graph of 20 calls, after 3 warm-ups: no host launch overhead) and
TFLOP/s of each of K7's forms in that dtype: in bfloat16 the ``mma`` form
(tensor cores, the route's), ``taps`` and ``im2col`` (wgmma over the
gathered rows), the tensor-core forms on weights packed once as the route
caches them; in float32
``taps`` (the route's) and ``im2col`` (CUDA cores); then the plain
version, and the yardstick ``F.silu(F.conv2d(x, w, b))`` in the same
dtype (cuDNN, two launches: conv with bias, then SiLU, as the TPU
shootout's XLA column was; float32 with TF32 off); the bound (the larger
of the bytes, x read once and y written once, over 3.35 TB/s and the
operations over the H100 SXM's peak for the type: 989 TFLOP/s bf16
tensor cores, 67 TFLOP/s float32 CUDA cores) and what sets it; and the
largest difference of each form from the plain version. The TPU tool's
two probes with wrong numerics (``dots``, ``dot1``: the least time a
kernel could take) are not ported: the bound plays their part. The last
line is every row as one JSON object. Exits nonzero without a CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import (
    conv_act_kernel,
    conv_act_plain,
    pack_im2col,
    pack_mma,
)

SHAPES = [  # (h, w, c_in, c_out, k), tools/prof/_prof_conv2.py:30
    (80, 80, 32, 32, 3),
    (80, 80, 64, 64, 3),
    (80, 80, 64, 80, 3),
    (80, 80, 80, 80, 3),
    (40, 40, 64, 64, 3),
]
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
FORMS_OF = {torch.bfloat16: ("mma", "taps", "im2col"),
            torch.float32: ("taps", "im2col")}


def graph_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``: CUDA events around the
    replay of a CUDA graph of ``iters`` calls, after ``warmup`` calls on
    a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_shape(s: int, h: int, w: int, c_in: int, c_out: int, k: int,
                  dtype: torch.dtype, seed: int = 0) -> dict:
    """One row: times (ms), TFLOP/s, the bound and each form's largest
    difference from the plain version, for S images in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.randn((s, c_in, h, w), generator=g, device=dev).to(dtype)
    wt = torch.randn((k * k * c_in, c_out), generator=g, device=dev) * 0.05
    b = torch.randn((c_out,), generator=g, device=dev) * 0.1
    w4 = wt.reshape(k, k, c_in, c_out).permute(3, 2, 0, 1).to(dtype).contiguous()
    bx = b.to(dtype)
    want = conv_act_plain(x, wt, b, k=k, act=True, layout="nchw").float()
    packed = ({"mma": pack_mma(wt, k), "im2col": pack_im2col(wt)}
              if dtype == torch.bfloat16 else {})
    forms = FORMS_OF[dtype]
    runs = {
        form: (lambda f=form: conv_act_kernel(
            x, wt, b, k=k, act=True, layout="nchw", form=f,
            packed=packed.get(f)))
        for form in forms
    }
    runs["plain"] = lambda: conv_act_plain(x, wt, b, k=k, act=True, layout="nchw")
    runs["library"] = lambda: F.silu(F.conv2d(x, w4, bx, 1, k // 2))
    row = {"S": s, "h": h, "w": w, "c_in": c_in, "c_out": c_out, "k": k,
           "dtype": str(dtype).removeprefix("torch.")}
    flops = 2 * k * k * c_in * c_out * s * h * w
    for name, fn in runs.items():
        ms = graph_ms(fn, iters=5 if name == "plain" else 20)
        row[f"{name}_ms"] = ms
        row[f"{name}_tflops"] = flops / ms / 1e9
        if name in forms:
            got = fn().float()
            row[f"{name}_max_diff"] = float((got - want).abs().max())
    size = x.element_size()
    nbytes = (x.numel() + s * c_out * h * w + wt.numel()) * size + b.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("prof_conv: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for s in [int(a) for a in argv] or [32, 8]:
        for h, w, c_in, c_out, k in SHAPES:
            for dtype, forms in FORMS_OF.items():
                r = profile_shape(s, h, w, c_in, c_out, k, dtype)
                rows.append(r)
                print(f"S={s} {h}x{w} {c_in:>3}->{c_out:<3} k{k} "
                      f"{r['dtype']:>8}: "
                      + "  ".join(f"{n} {r[n + '_ms'] * 1e3:8.1f}us "
                                  f"({r[n + '_tflops']:6.2f} TF/s)"
                                  for n in (*forms, "plain", "library"))
                      + f"  bound {r['bound_ms'] * 1e3:.2f}us "
                      f"({r['bound_by']})  max diff " + ", ".join(
                          f"{f} {r[f + '_max_diff']:.3g}" for f in forms)
                      + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
