"""Training CLI: fit a YOLO detector (v8 / YOLO11; detect, segment or
pose) on a detection dataset, on one device or over a mesh of ranks.

Counterpart of ``strongsort_yolo_tpu/tools/train.py``. Data: a YOLO-txt
layout (an ``images`` dir + per-image ``cls cx cy w h`` normalized label
txts in ``labels``) or the built-in synthetic tasks, drawn here as the
JAX tool draws them: the same ``np.random.Generator`` gives the same
arrays. The model starts from ``init_model`` seeded with ``--seed``,
default 0 (a ``torch.Generator``; the JAX PRNG cannot be replayed); the
data's generator is seeded with 0 whatever ``--seed``, as in the JAX
tool. Writes the JAX
package's ``.npz`` checkpoint, which both packages load.

Usage:
    python -m strongsort_yolo_tpu_torch.tools.train --steps 500 \\
        [--data DIR | --synthetic] [--model yolov8n] [--imgsz 320]
        [--batch 8] [--lr 1e-3] [--cosine] [--save out.npz]
        [--seed 0] [--device cuda] [--dp N] [--tp M]

As in the JAX tool, it trains over a mesh when ``--dp`` is given, or
``--tp`` is above 1, or more than one CUDA device is visible (to
``--device cuda``; ``cuda:K`` names one card): N x M
processes (``parallel/ranks.launch``), position k on card k % (visible
cards), so a mesh may name one card twice; ``--device cpu`` puts every
position on the CPU. ``--batch`` is the global batch, split over dp;
rank 0 logs and saves, and ``main`` returns its record.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def synthetic_batch(rng, batch, imgsz, max_gt=8):
    """Rectangles-on-noise detection task (class = brightness bucket)."""
    imgs = rng.uniform(0.0, 0.3, (batch, imgsz, imgsz, 3)).astype(np.float32)
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    cls = np.zeros((batch, max_gt), np.int32)
    valid = np.zeros((batch, max_gt), bool)
    for b in range(batch):
        n = rng.integers(1, max_gt // 2 + 1)
        for i in range(n):
            w = rng.uniform(imgsz * 0.15, imgsz * 0.4)
            h = rng.uniform(imgsz * 0.15, imgsz * 0.4)
            x1 = rng.uniform(0, imgsz - w)
            y1 = rng.uniform(0, imgsz - h)
            c = int(rng.integers(0, 3))
            shade = 0.5 + 0.16 * c
            imgs[b, int(y1):int(y1 + h), int(x1):int(x1 + w)] = shade
            boxes[b, i] = (x1, y1, x1 + w, y1 + h)
            cls[b, i] = c
            valid[b, i] = True
    return imgs, {"boxes": boxes, "cls": cls, "valid": valid}


def synthetic_batch_seg(rng, batch, imgsz, max_gt=8):
    """Ellipses-on-noise segmentation task: the gt MASK is the ellipse,
    the gt box its bounding box — so a mask head that merely repaints
    the box is measurably wrong."""
    hm = imgsz // 4  # proto resolution
    imgs = rng.uniform(0.0, 0.3, (batch, imgsz, imgsz, 3)).astype(np.float32)
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    cls = np.zeros((batch, max_gt), np.int32)
    valid = np.zeros((batch, max_gt), bool)
    masks = np.zeros((batch, max_gt, hm, hm), np.float32)
    yy, xx = np.mgrid[0:imgsz, 0:imgsz]
    yym, xxm = np.mgrid[0:hm, 0:hm]
    for b in range(batch):
        n = rng.integers(1, max_gt // 2 + 1)
        for i in range(n):
            rw = rng.uniform(imgsz * 0.09, imgsz * 0.2)
            rh = rng.uniform(imgsz * 0.09, imgsz * 0.2)
            cx = rng.uniform(rw, imgsz - rw)
            cy = rng.uniform(rh, imgsz - rh)
            c = int(rng.integers(0, 3))
            shade = 0.5 + 0.16 * c
            ell = ((xx - cx) / rw) ** 2 + ((yy - cy) / rh) ** 2 <= 1.0
            imgs[b][ell] = shade
            boxes[b, i] = (cx - rw, cy - rh, cx + rw, cy + rh)
            cls[b, i] = c
            valid[b, i] = True
            masks[b, i] = (
                ((xxm + 0.5) * 4 - cx) / rw) ** 2 + (
                ((yym + 0.5) * 4 - cy) / rh) ** 2 <= 1.0
    return imgs, {"boxes": boxes, "cls": cls, "valid": valid, "masks": masks}


# One distinct saturated color per keypoint INDEX — the visual identity
# that makes "keypoint k" learnable (real pose keypoints are likewise
# visually distinct body parts).
POSE_KPT_COLORS = np.asarray(
    [
        [1.0, 0.1, 0.1],  # k0 red
        [0.1, 1.0, 0.1],  # k1 green
        [0.15, 0.25, 1.0],  # k2 blue
        [1.0, 0.9, 0.1],  # k3 yellow
        [1.0, 0.15, 1.0],  # k4 magenta
    ],
    np.float32,
)


def synthetic_batch_pose(rng, batch, imgsz, n_kpt=5, max_gt=8):
    """Rectangles with drawn color-coded DOTS at random in-box
    positions; gt keypoint k is the center of the k-colored dot — not
    derivable from the box, so the kpt head must localize each dot
    visually (and the colors make the index identifiable, as body
    parts are in real pose data)."""
    imgs = rng.uniform(0.0, 0.3, (batch, imgsz, imgsz, 3)).astype(np.float32)
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    cls = np.zeros((batch, max_gt), np.int32)
    valid = np.zeros((batch, max_gt), bool)
    kpts = np.zeros((batch, max_gt, n_kpt, 3), np.float32)
    r = 3  # dot radius in training pixels (7x7 at imgsz)
    for b in range(batch):
        n = rng.integers(1, max_gt // 2 + 1)
        placed = 0
        for i in range(n):
            # rejection-sample a box DISJOINT from the ones already
            # drawn — an overlapping fill would erase earlier boxes'
            # dots, leaving gt keypoints with no visual evidence
            for _ in range(12):
                w = rng.uniform(imgsz * 0.2, imgsz * 0.4)
                h = rng.uniform(imgsz * 0.2, imgsz * 0.4)
                x1 = rng.uniform(0, imgsz - w)
                y1 = rng.uniform(0, imgsz - h)
                cand = np.asarray((x1, y1, x1 + w, y1 + h))
                prev = boxes[b, :placed]
                if placed == 0 or not np.any(
                    (cand[0] < prev[:, 2]) & (cand[2] > prev[:, 0])
                    & (cand[1] < prev[:, 3]) & (cand[3] > prev[:, 1])
                ):
                    break
            else:
                continue  # no disjoint spot; draw fewer objects
            c = int(rng.integers(0, 3))
            imgs[b, int(y1):int(y1 + h), int(x1):int(x1 + w)] = (
                0.5 + 0.16 * c
            )
            pts = np.zeros((n_kpt, 2), np.float32)
            for k in range(n_kpt):
                # keep dots from covering each other (min 2r+2 apart)
                for _ in range(12):
                    kx = x1 + rng.uniform(0.12, 0.88) * w
                    ky = y1 + rng.uniform(0.12, 0.88) * h
                    if k == 0 or np.min(
                        np.abs(pts[:k] - (kx, ky)).max(axis=1)
                    ) > 2 * r + 2:
                        break
                pts[k] = (kx, ky)
                iy, ix = int(ky), int(kx)
                imgs[
                    b, max(iy - r, 0):iy + r + 1, max(ix - r, 0):ix + r + 1
                ] = POSE_KPT_COLORS[k % len(POSE_KPT_COLORS)]
                kpts[b, i, k] = (kx, ky, 1.0)
            boxes[b, i] = (x1, y1, x1 + w, y1 + h)
            cls[b, i] = c
            valid[b, i] = True
            placed = i + 1
    return imgs, {"boxes": boxes, "cls": cls, "valid": valid, "kpts": kpts}


def yolo_txt_batches(data_dir, rng, batch, imgsz, max_gt=32):
    """Stream batches from a YOLO-format dataset directory (cv2)."""
    from strongsort_yolo_tpu_torch.media.video import _cv2

    cv2 = _cv2()
    img_dir = os.path.join(data_dir, "images")
    lbl_dir = os.path.join(data_dir, "labels")
    files = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".jpg", ".png", ".jpeg"))
    )
    while True:
        sel = rng.choice(len(files), batch)
        imgs = np.zeros((batch, imgsz, imgsz, 3), np.float32)
        boxes = np.zeros((batch, max_gt, 4), np.float32)
        cls = np.zeros((batch, max_gt), np.int32)
        valid = np.zeros((batch, max_gt), bool)
        for b, fi in enumerate(sel):
            img = cv2.imread(os.path.join(img_dir, files[fi]))
            img = cv2.resize(img, (imgsz, imgsz))
            imgs[b] = img[..., ::-1] / 255.0
            lbl = os.path.join(
                lbl_dir, os.path.splitext(files[fi])[0] + ".txt"
            )
            if os.path.exists(lbl):
                with open(lbl) as f:
                    for i, line in enumerate(f):
                        if i >= max_gt:
                            break
                        c, cx, cy, w, h = map(float, line.split()[:5])
                        boxes[b, i] = (
                            (cx - w / 2) * imgsz, (cy - h / 2) * imgsz,
                            (cx + w / 2) * imgsz, (cy + h / 2) * imgsz,
                        )
                        cls[b, i] = int(c)
                        valid[b, i] = True
        yield imgs, {"boxes": boxes, "cls": cls, "valid": valid}


class _StepTimer:
    """The time of each step: CUDA events recorded around it on a CUDA
    device, read once at the end; the host clock on a CPU."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.marks = []
        self._event = lambda: torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.marks.append([self._event(), self._event()])
            self.marks[-1][0].record()
        else:
            self.marks.append([time.perf_counter(), None])

    def stop(self) -> None:
        if self.cuda:
            self.marks[-1][1].record()
        else:
            self.marks[-1][1] = time.perf_counter()

    def ms(self) -> list[float]:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in self.marks]
        self.marks[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self.marks]


def main(argv=None) -> dict:
    """-> {"losses": [(step, {metric: value}), ...] at the logged steps,
    "step_ms": [ms of each step: on a CUDA device the card's time from the
    step's first upload to its last update, by CUDA events], "seconds" (the
    training loop's wall time, data included)}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", default=None, help="YOLO-format dataset dir")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--model", default="yolov8n")
    ap.add_argument("--nc", type=int, default=None)
    ap.add_argument("--kpt", type=int, default=None,
                    help="keypoints per object (pose models)")
    ap.add_argument("--imgsz", type=int, default=320)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cosine", action="store_true",
                    help="warmup + cosine-decay the lr over --steps")
    ap.add_argument("--save", default=None, help=".npz checkpoint path")
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from strongsort_yolo_tpu_torch.parallel.mesh import make_mesh
    from strongsort_yolo_tpu_torch.parallel.ranks import launch

    device = torch.device(args.device)
    cards = (torch.cuda.device_count()
             if device.type == "cuda" and device.index is None else 1)
    if args.dp or args.tp > 1 or cards > 1:
        dp = args.dp or max(cards // args.tp, 1)
        if device.type == "cuda":
            devices = [torch.device("cuda", k % cards)
                       for k in range(dp * args.tp)]
            threads = None
        else:
            devices = [device] * (dp * args.tp)
            threads = max(torch.get_num_threads() // len(devices), 1)
        mesh = make_mesh(dp=dp, tp=args.tp, devices=devices)
        return launch(_train, mesh, (args,), threads=threads)[0]
    return _train(None, args)


def _train(mesh, args) -> dict:
    """The training loop of :func:`main`; over ``mesh``, one rank's."""
    import torch
    import torch.distributed as dist

    from strongsort_yolo_tpu_torch.models.porting import save_npz_checkpoint
    from strongsort_yolo_tpu_torch.models.yolo import YoloConfig, build_model
    from strongsort_yolo_tpu_torch.train.trainer import (
        init_train_state, make_optimizer, make_train_step, shard_batch,
        warmup_cosine_decay_schedule,
    )

    cfg = build_model(args.model)
    if not isinstance(cfg, YoloConfig):
        raise ValueError(f"{args.model}: the trainer takes v8 and YOLO11 "
                         "models (the JAX trainer's)")
    if args.nc:
        cfg = dataclasses.replace(cfg, nc=args.nc)
    if cfg.task == "pose" and args.kpt:
        cfg = dataclasses.replace(cfg, kpt=(args.kpt, 3))
    lr = args.lr
    if args.cosine:
        lr = warmup_cosine_decay_schedule(
            0.0, args.lr, min(100, max(args.steps // 10, 1)),
            args.steps, args.lr * 0.01,
        )
    tx = make_optimizer(lr)
    state = init_train_state(args.seed, cfg, tx, torch.device(args.device),
                             mesh=mesh)
    device = next(state.model.parameters()).device
    lead = mesh is None or dist.get_rank() == 0
    step = make_train_step(cfg, args.imgsz, tx)

    rng = np.random.default_rng(0)
    if args.data:
        data = yolo_txt_batches(args.data, rng, args.batch, args.imgsz)
    elif cfg.task == "segment":
        data = iter(
            lambda: synthetic_batch_seg(rng, args.batch, args.imgsz), None
        )
    elif cfg.task == "pose":
        data = iter(
            lambda: synthetic_batch_pose(
                rng, args.batch, args.imgsz, n_kpt=cfg.kpt[0]
            ),
            None,
        )
    else:
        data = iter(lambda: synthetic_batch(rng, args.batch, args.imgsz), None)
    # the loss is read at the logged steps only, so the host queues a step
    # while the card runs the last; a step's time is the card's, between
    # events recorded around it (the host clock on a CPU, which runs each
    # op as it is called)
    timer = _StepTimer(device)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        images, targets = next(data)
        timer.start()
        if mesh is not None:
            images, targets = shard_batch(mesh, images, targets)
        state, metrics = step(state, images, targets)
        timer.stop()
        if lead and (i % args.log_every == 0 or i == args.steps - 1):
            logged = {k: float(v) for k, v in metrics.items()}
            losses.append((i, logged))
            extra = "".join(
                f" {k.split('_')[0]}={logged[k]:.4f}"
                for k in ("seg_loss", "kpt_loss", "kobj_loss")
                if k in logged
            )
            print(
                f"step {i}: loss={logged['loss']:.4f} "
                f"box={logged['box_loss']:.4f} "
                f"cls={logged['cls_loss']:.4f} "
                f"dfl={logged['dfl_loss']:.4f} "
                f"fg={logged['num_fg']:.1f}" + extra,
                flush=True,
            )
    step_ms = timer.ms()
    seconds = time.perf_counter() - t0
    if lead:
        print(f"{args.steps} steps in {seconds:.2f} s, median "
              f"{float(np.median(step_ms)):.2f} ms a step", flush=True)
    if args.save:
        sd = (state.model.state_dict() if mesh is None
              else state.ranks.state_dict(state.model))
        if lead:
            save_npz_checkpoint(args.save, sd, cfg)
            print(f"saved {args.save}")
    return {"losses": losses, "step_ms": step_ms, "seconds": seconds}


if __name__ == "__main__":
    main()
