"""Take K1 (the letterbox) and K4 (the banded crop) apart on a CUDA device.

    python -m strongsort_yolo_tpu_torch.tools.prof_resample [ROUNDS [CHECKOUT ...]]

Builds copies of ``csrc/letterbox.cu`` and ``csrc/banded_crop.cu`` with
one part changed each, with the package's nvcc flags, and times each
copy's C entry point by CUDA-graph replay (``prof_conv.graph_ms``) in
ROUNDS rounds (default 2), the order reversed every other round:

- K1 at (8, 1080, 1920, 3) u8 -> (8, 3, 640, 640) bf16 and at
  (8, 481, 853, 3) (two taps a side, rows of 2559 bytes): as built, and
  without the byte / 255 table (every value through the products and
  the division);
- K4 on 480 slots (60 seeded boxes on each of 8 1080p frames, a bf16
  pyramid): as built, with plain stores in place of the streaming ones,
  without the source gathers (each tap reads a number made from its
  index), without the stores (a condition no value meets), and without
  both: what is left is the work of the instructions alone.

Each CHECKOUT (the root of another checkout of the repository, such as
the parent commit's) has its two sources built as they are and timed in
the same rounds, named by the directory's base name.

The copies that compute the same function are checked bit for bit
against the package's kernels first. One line per round and kernel,
then the card's name and power limit. Exits nonzero without a CUDA
device.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from strongsort_yolo_tpu_torch.ops.crops import banded_prep, pyramid_stack
from strongsort_yolo_tpu_torch.ops.cuda import _build
from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import banded_crop
from strongsort_yolo_tpu_torch.ops.cuda.resize_kernel import letterbox_u8
from strongsort_yolo_tpu_torch.ops.letterbox import (
    PAD_VALUE,
    letterbox_params,
    resize_taps,
)
from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "prof_resample")
K4_STORE = ("__stcs(reinterpret_cast<uint4*>(dst), "
            "make_uint4(w[0], w[1], w[2], w[3]));")
K4_GATHER_A = "a[h][c] = load_f<T>(line + c * plane + x0[h]);"
K4_GATHER_B = ("b[h][c] = wx1[h] != 0.0f ? load_f<T>(line + c * plane + x1[h])"
               " : 0.0f;")
K4_ROW_STORE = "    store_run(dst + c * plane_out, v, whole, n);"
# (kernel, name) -> [(text, replacement), ...] on the kernel's source
VARIANTS = {
    ("K1", "as built"): [],
    ("K1", "no table"): [
        ("if (unit_row && wx0 == 1.0f && wx1 == 0.0f) {", "if (false) {")],
    ("K4", "as built"): [],
    ("K4", "plain stores"): [
        (K4_STORE, "*reinterpret_cast<uint4*>(dst) = "
                   "make_uint4(w[0], w[1], w[2], w[3]);")],
    ("K4", "no gathers"): [
        (K4_GATHER_A, "a[h][c] = (float)(x0[h] + c) * 1e-3f;"),
        (K4_GATHER_B, "b[h][c] = (float)x1[h] * 1e-3f;")],
    ("K4", "no stores"): [
        (K4_ROW_STORE, "    if (v[0] < -1.0f) "
                       "store_run(dst + c * plane_out, v, whole, n);")],
}
VARIANTS[("K4", "neither")] = (VARIANTS[("K4", "no gathers")]
                               + VARIANTS[("K4", "no stores")])
K1_SHAPES = ((1080, 1920), (481, 853))
SOURCES = {"K1": "letterbox.cu", "K4": "banded_crop.cu"}
ENTRIES = {"K1": "ssyt_letterbox_u8", "K4": "ssyt_banded_crop"}


def build(kernel: str, name: str, edits, csrc: str = _build.CSRC) -> str:
    """Compile the kernel's source in ``csrc`` with ``edits`` into a
    library of its own; -> its path."""
    with open(os.path.join(csrc, SOURCES[kernel])) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{kernel} {name}: {old!r} not in the source")
        src = src.replace(old, new)
    tag = f"{kernel}_{name.replace(' ', '_')}"
    cu, so = os.path.join(OUT, tag + ".cu"), os.path.join(OUT, tag + ".so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    cu], check=True, capture_output=True, timeout=600)
    return so


def k4_boxes(rng, n: int, h: int, w: int) -> np.ndarray:
    """n crop boxes of one frame: sizes that select each pyramid level,
    boxes across all four frame edges, and degenerate ones."""
    frac = rng.choice([0.05, 0.12, 0.3, 0.6, 0.95], n)
    bw = frac * w * rng.uniform(0.3, 1.0, n)
    bh = frac * h * rng.uniform(0.5, 1.0, n)
    x1 = rng.uniform(-30, w - bw / 2)
    y1 = rng.uniform(-30, h - bh / 2)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
    boxes[:8] = [[0, 0, 0, 0], [200, 300, 200, 300.5],
                 [-60, 400, 90, 700], [w - 90, 100, w + 60, 420],
                 [700, -80, 860, 160], [900, h - 150, 1060, h + 90],
                 [0, 0, w, h], [w - 1, h - 1, w + 30, h + 50]]
    return boxes.astype(np.float32)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("prof_resample: no CUDA device", file=sys.stderr)
        return 1
    rounds = int(argv[0]) if argv else 2
    jobs = {key: (*key, edits) for key, edits in VARIANTS.items()}
    checkouts = []
    for root in argv[1:]:
        name = os.path.basename(os.path.normpath(root))
        checkouts.append(name)
        other = os.path.join(root, "strongsort_yolo_tpu_torch", "csrc")
        for kernel in SOURCES:
            jobs[(kernel, name)] = (kernel, name, [], other)
    os.makedirs(OUT, exist_ok=True)
    _build.lib()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = {key: pool.submit(build, *job) for key, job in jobs.items()}
        libs = {key: ctypes.CDLL(fut.result()) for key, fut in libs.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    k1_in = {}  # frame geometry -> (frames, letterbox params, taps)
    for hw in K1_SHAPES:
        frames = torch.from_numpy(
            rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8)).to(dev)
        lp = letterbox_params(*hw, 640)
        k1_in[hw] = frames, lp, resize_taps(hw, lp, dev)
    frames = k1_in[(1080, 1920)][0]
    imgs = frames.permute(0, 3, 1, 2).to(torch.bfloat16) / torch.full(
        (), 255.0, dtype=torch.bfloat16, device=dev)
    pyr = pyramid_stack(imgs)
    boxes = np.concatenate([k4_boxes(rng, 60, 1080, 1920) for _ in range(8)])
    scal, ints = banded_prep(torch.from_numpy(boxes).to(dev), (1080, 1920),
                             pyr.dims, (128, 64))
    slot_frame = (torch.arange(480, device=dev) // 60).to(torch.int32)
    s, _, sum_h, width = pyr.stack.shape

    def run(key, hw=None):
        fn = getattr(libs[key], ENTRIES[key[0]])
        fn.argtypes = _build._SIGNATURES[ENTRIES[key[0]]]
        if key[0] == "K1":
            frames, lp, taps = k1_in[hw]
            out = torch.empty((8, 3, 640, 640), dtype=torch.bfloat16,
                              device=dev)
            err = fn(frames.data_ptr(), out.data_ptr(), 1,
                     taps.idx.data_ptr(), taps.w.data_ptr(), 8, *hw,
                     640, lp.new_h, lp.new_w, lp.top, lp.left, PAD_VALUE,
                     stream())
        else:
            out = torch.empty((480, 3, 128, 64), dtype=torch.bfloat16,
                              device=dev)
            err = fn(pyr.stack.data_ptr(), 1, pyr.row_off.data_ptr(),
                     len(pyr.dims), scal.data_ptr(), ints.data_ptr(),
                     slot_frame.data_ptr(), out.data_ptr(), s, sum_h, width,
                     480, 128, 64, stream())
        _build.check(err, f"{key[0]} {key[1]}")
        return out

    cases = [("K1", hw) for hw in K1_SHAPES] + [("K4", None)]
    want = {("K1", hw): letterbox_u8(k1_in[hw][0], k1_in[hw][1],
                                     dtype=torch.bfloat16, taps=k1_in[hw][2])
            for hw in K1_SHAPES}
    want[("K4", None)] = banded_crop(pyr, scal, ints, slot_frame)
    same = [k for k in libs
            if k[1] in ("as built", "no table", "plain stores", *checkouts)]
    for kernel, hw in cases:
        for key in same:
            if key[0] == kernel and not torch.equal(run(key, hw),
                                                    want[(kernel, hw)]):
                raise AssertionError(f"{key} {hw} differs from the "
                                     "package's kernel")
    for r in range(rounds):
        for kernel, hw in cases:
            keys = [k for k in libs if k[0] == kernel]
            if r % 2:
                keys = keys[::-1]
            times = {k[1]: graph_ms(lambda k=k: run(k, hw)) for k in keys}
            at = f" {hw[0]}x{hw[1]}" if hw else ""
            print(f"round {r} {kernel}{at} ms by graph replay: " + ", ".join(
                f"{name} {ms:.4f}" for name, ms in times.items()), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
