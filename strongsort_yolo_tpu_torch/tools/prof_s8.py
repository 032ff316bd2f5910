"""Time K8, the int8 conv, on a CUDA device at yolov8n's int8 convs.

    python -m strongsort_yolo_tpu_torch.tools.prof_s8 [S]
    python -m strongsort_yolo_tpu_torch.tools.prof_s8 --depthwise [S] [ROUNDS]

For each of the 32 int8 convs of one yolov8n 640 forward (``YOLOV8N_INT8``,
in the forward's order), S images (default 8) in bfloat16, seeded inputs
and weights, a static scale, SiLU: the device time by CUDA-graph replay
(``prof_conv.graph_ms``) of K8 as the wrapper runs it (its N tile from
``quant_kernel.n_tile``), of K8 with each tile of ``N_TILES``, of its
quantize pass alone, and of cuDNN's bf16 conv + SiLU of the dequantized
weights (a different function, the yardstick); the bound (bytes: x read
once, the weights once, the output written once, over 3.35 TB/s; or
2 x MACs over 1,979 TOPS); the time of K8's first form (``mma.sync``
m16n8k32, x quantized again per tap and per 64 channels as it loaded;
the same card type) beside it. Then the sums over each conv class
and over all 32. Every K8 output is checked against ``conv_s8_plain``
(int32 sums bit for bit). The last line is every row as one JSON object.
Exits nonzero without a CUDA device.

With ``--depthwise``: K8's depthwise form at yolo11n-pose's pe conv (S
images of 128 channels at 20 x 20, k 3, act=False, bf16), ROUNDS times
in turns with cuDNN's bf16 depthwise conv and conv + SiLU of the
dequantized weights, after checking its int32 sums and outputs bit for
bit against ``conv_s8_plain`` in both dtypes and both scales, there and
on a plane cut into bands (k 5, stride 2). It calls only functions that
every K8 form has, so it also times an older checkout's package: run
this file with that checkout on ``PYTHONPATH``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.ops.cuda import quant_kernel as qk
from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

# (c_in, h, w, c_out, k, stride, first form's K8 ms, cuDNN ms): the int8
# convs of one S=8 yolov8n 640 bf16 forward in its order, with the times
# that chip_smoke.py phase 8a measured for K8's first form (mma.sync,
# x quantized as it loaded) and for cuDNN's bf16 conv + SiLU (graph
# replay, calibrated scales, NVIDIA H100 80GB HBM3, 700.00 W)
YOLOV8N_INT8 = [
    (64, 80, 80, 128, 3, 2, 0.0901, 0.0322),
    (128, 40, 40, 128, 1, 1, 0.0268, 0.0145),
    (64, 40, 40, 64, 3, 1, 0.0704, 0.0227),
    (64, 40, 40, 64, 3, 1, 0.0708, 0.0224),
    (64, 40, 40, 64, 3, 1, 0.0688, 0.0226),
    (64, 40, 40, 64, 3, 1, 0.0699, 0.0232),
    (256, 40, 40, 128, 1, 1, 0.0456, 0.0159),
    (128, 40, 40, 256, 3, 2, 0.1735, 0.0276),
    (256, 20, 20, 256, 1, 1, 0.0429, 0.0112),
    (128, 20, 20, 128, 3, 1, 0.1305, 0.0200),
    (128, 20, 20, 128, 3, 1, 0.1296, 0.0197),
    (384, 20, 20, 256, 1, 1, 0.0616, 0.0119),
    (256, 20, 20, 128, 1, 1, 0.0426, 0.0092),
    (512, 20, 20, 256, 1, 1, 0.0794, 0.0205),
    (384, 40, 40, 128, 1, 1, 0.0637, 0.0155),
    (64, 40, 40, 64, 3, 1, 0.0686, 0.0233),
    (64, 40, 40, 64, 3, 1, 0.0686, 0.0224),
    (192, 40, 40, 128, 1, 1, 0.0355, 0.0148),
    (192, 80, 80, 64, 1, 1, 0.0396, 0.0235),
    (32, 80, 80, 32, 3, 1, 0.0520, 0.0307),
    (32, 80, 80, 32, 3, 1, 0.0513, 0.0300),
    (96, 80, 80, 64, 1, 1, 0.0250, 0.0232),
    (64, 80, 80, 64, 3, 2, 0.0713, 0.0258),
    (192, 40, 40, 128, 1, 1, 0.0359, 0.0146),
    (64, 40, 40, 64, 3, 1, 0.0694, 0.0224),
    (64, 40, 40, 64, 3, 1, 0.0693, 0.0222),
    (192, 40, 40, 128, 1, 1, 0.0359, 0.0146),
    (128, 40, 40, 128, 3, 2, 0.1352, 0.0217),
    (384, 20, 20, 256, 1, 1, 0.0613, 0.0120),
    (128, 20, 20, 128, 3, 1, 0.1289, 0.0200),
    (128, 20, 20, 128, 3, 1, 0.1284, 0.0201),
    (384, 20, 20, 256, 1, 1, 0.0609, 0.0115),
]
HBM_BYTES_PER_MS = 3.35e9
INT8_OPS_PER_MS = 1979e9


def conv_class(c_in: int, h: int, w: int, c_out: int, k: int,
               stride: int) -> str:
    """The conv classes of PERF.md's K8 table."""
    if k == 1:
        return "1x1"
    if stride == 2:
        return "3x3 s2"
    return f"3x3 s1 {c_in}->{c_out} at {h}x{w}"


def bound_ms(nbytes: int, macs: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, 2 * macs / INT8_OPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_conv(s: int, c_in: int, h: int, w: int, c_out: int, k: int,
                 stride: int, seed: int = 0) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    x = (torch.randn((s, c_in, h, w), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    wq = torch.randint(-127, 128, (c_out, c_in, k, k), generator=g,
                       device=dev, dtype=torch.int32).to(torch.int8)
    ws = torch.rand((c_out,), generator=g, device=dev) * 2e-3 + 1e-4
    b = torch.randn((c_out,), generator=g, device=dev) * 0.5
    xs = torch.full((), 6.0 / 127.0, device=dev)
    pad = (k - 1) // 2
    kw = dict(stride=stride, pad=pad, groups=1, act=True)
    packed = qk.pack_s8(wq)
    out = qk.conv_s8(x, wq, ws, b, xs, **kw, packed=packed)
    sums = qk.conv_s8(x, wq, ws, b, xs, **kw, packed=packed, sums=True)
    if not torch.equal(sums, qk.conv_s8_plain(x, wq, ws, b, xs, **kw,
                                              sums=True)):
        raise AssertionError(f"K8 sums differ at {(c_in, h, w, c_out, k)}")
    row = {"S": s, "c_in": c_in, "h": h, "w": w, "c_out": c_out, "k": k,
           "stride": stride, "n_tile": qk.n_tile(c_out)}
    row["ms"] = graph_ms(lambda: qk.conv_s8(x, wq, ws, b, xs, **kw,
                                            packed=packed))
    for bn in qk.N_TILES:
        def run(bn=bn):
            o = torch.empty_like(out)
            qk.launch(x, packed, ws, b, xs, o, k=k, stride=stride, pad=pad,
                      depthwise=False, act=True, bn=bn)
            return o
        if not torch.equal(run(), out):
            raise AssertionError(f"K8 n_tile {bn} differs at "
                                 f"{(c_in, h, w, c_out, k)}")
        row[f"bn{bn}_ms"] = graph_ms(run)
    row["quantize_ms"] = graph_ms(lambda: qk.quantize_codes(x, xs))
    w16 = (wq.float() * ws[:, None, None, None]).to(torch.bfloat16)
    b16 = b.to(torch.bfloat16)
    row["library_ms"] = graph_ms(
        lambda: F.silu(F.conv2d(x, w16, b16, stride, pad)))
    nbytes = (x.numel() * 2 + wq.numel() + ws.numel() * 4 + b.numel() * 4
              + out.numel() * 2)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes,
                                                out.numel() * c_in * k * k)
    return row


def depthwise(s: int, rounds: int, card: str) -> int:
    """The --depthwise mode (the module's note); -> the exit code."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for (n, c, h, w, k, stride, act) in ((s, 128, 20, 20, 3, 1, False),
                                          (1, 6, 150, 90, 5, 2, True)):
        x32 = torch.randn((n, c, h, w), generator=g, device=dev) * 1.5
        wq = torch.randint(-127, 128, (c, 1, k, k), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8)
        ws = torch.rand((c,), generator=g, device=dev) * 2e-3 + 1e-4
        b = torch.randn((c,), generator=g, device=dev) * 0.5
        kw = dict(stride=stride, pad=(k - 1) // 2, groups=c, act=act)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            for xs in (x.float().abs().amax() / 127.0,
                       torch.full((), 6.0 / 127.0, device=dev)):
                args = (x, wq, ws, b, xs)
                same = torch.equal(qk.conv_s8(*args, **kw, sums=True),
                                   qk.conv_s8_plain(*args, **kw, sums=True))
                if not act:
                    same &= torch.equal(qk.conv_s8(*args, **kw),
                                        qk.conv_s8_plain(*args, **kw))
                ok &= same
                print(f"depthwise ({n}, {c}, {h}, {w}) k{k} s{stride} {dt}: "
                      f"bit-identical to conv_s8_plain {same}", flush=True)
    x = (torch.randn((s, 128, 20, 20), generator=g, device=dev) * 1.5).to(
        torch.bfloat16)
    wq = torch.randint(-127, 128, (128, 1, 3, 3), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    ws = torch.rand((128,), generator=g, device=dev) * 2e-3 + 1e-4
    b = torch.randn((128,), generator=g, device=dev) * 0.5
    xs = torch.full((), 6.0 / 127.0, device=dev)
    kw = dict(stride=1, pad=1, groups=128, act=False)
    packed = qk.pack_s8(wq, 128)
    w16 = (wq.float() * ws[:, None, None, None]).to(torch.bfloat16)
    b16 = b.to(torch.bfloat16)
    for r in range(rounds):
        ms = graph_ms(lambda: qk.conv_s8(x, wq, ws, b, xs, **kw, packed=packed))
        conv = graph_ms(lambda: F.conv2d(x, w16, b16, 1, 1, 1, 128))
        silu = graph_ms(lambda: F.silu(F.conv2d(x, w16, b16, 1, 1, 1, 128)))
        print(f"depthwise pe conv S={s} bf16, round {r}: K8 {ms:.4f} ms, cuDNN "
              f"bf16 depthwise conv {conv:.4f} ms, + SiLU {silu:.4f} ms "
              f"(graph replay) [{card}]", flush=True)
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("prof_s8: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if argv and argv[0] == "--depthwise":
        return depthwise(int(argv[1]) if len(argv) > 1 else 8,
                         int(argv[2]) if len(argv) > 2 else 2, card)
    s = int(argv[0]) if argv else 8
    rows, classes = [], {}
    for i, (*shape, first, first_cudnn) in enumerate(YOLOV8N_INT8):
        r = profile_conv(s, *shape, seed=i)
        r["first_ms"], r["first_library_ms"] = first, first_cudnn
        rows.append(r)
        print(f"S={s} ({shape[0]}, {shape[1]}, {shape[2]})->{shape[3]} "
              f"k{shape[4]} s{shape[5]}: K8 {r['ms']:.4f} ms (n_tile "
              f"{r['n_tile']}; " + ", ".join(
                  f"bn{bn} {r[f'bn{bn}_ms']:.4f}" for bn in qk.N_TILES)
              + f"; quantize {r['quantize_ms']:.4f}), first form {first:.4f}, "
              f"cuDNN {r['library_ms']:.4f}, bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}) [{card}]", flush=True)
        c = classes.setdefault(conv_class(*shape), dict.fromkeys(
            ("n", "ms", "first_ms", "library_ms", "quantize_ms", "bound_ms"),
            0.0))
        c["n"] += 1
        for key in ("ms", "first_ms", "library_ms", "quantize_ms",
                    "bound_ms"):
            c[key] += r[key]
    for name, c in classes.items():
        print(f"class {name}: {int(c['n'])} convs, K8 {c['ms']:.4f} ms "
              f"(quantize {c['quantize_ms']:.4f}), first form "
              f"{c['first_ms']:.4f}, "
              f"cuDNN {c['library_ms']:.4f}, bound {c['bound_ms']:.6f} [{card}]")
    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "first_ms", "library_ms", "quantize_ms", "bound_ms",
        *(f"bn{bn}_ms" for bn in qk.N_TILES))}
    print(f"all {len(rows)} convs: " + ", ".join(
        f"{k} {v:.4f}" for k, v in total.items()) + f" [{card}]")
    print(json.dumps({"card": card, "rows": rows, "classes": classes,
                      "total": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
