"""Train the AFLink tracklet-link classifier on synthetic trajectories.

Counterpart of the repo's ``tools/train_aflink.py`` for the port's
``AFLink`` (``track/aflink.py``): the same trajectories and pairs, draw
for draw from ``--seed``, the same Adam (lr 1e-3) on the mean binary
cross-entropy with logits, initial weights from a ``torch.Generator``
seeded with ``--seed``. Writes the JAX package's ``.npz`` layout, which
both packages load.

Data: smooth synthetic trajectories (constant velocity + acceleration
noise + per-frame jitter, slowly-varying box size) in a 1920x1080
field. Positives: one trajectory cut at a random point with a 1..30
frame gap — the two sides must link. Negatives: the tail of one
trajectory against the head segment of the SPATIALLY NEAREST other
trajectory at a plausible gap (hard negatives), plus random pairs.

Usage:
    python -m strongsort_yolo_tpu_torch.tools.train_aflink --out PATH
        [--seed 0] [--steps 1500] [--batch 512] [--device cuda]

``--out`` is required: the shipped ``assets/aflink_synth.npz`` is the JAX
tool's and is not overwritten here.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.track.aflink import (
    AFLink, init_aflink, no_tf32, pair_features, save_aflink,
)


def make_trajectories(rng: np.random.Generator, n: int, t_len: int = 240):
    """-> list of (t_len, 5) arrays [frame, x1, y1, x2, y2]."""
    out = []
    for _ in range(n):
        pos = rng.uniform([100, 100], [1820, 980])
        vel = rng.normal(0, 3.0, 2)
        w = rng.uniform(40, 160)
        h = w * rng.uniform(1.6, 2.6)
        rows = []
        for t in range(t_len):
            vel += rng.normal(0, 0.25, 2)
            vel *= 0.999
            pos = pos + vel
            w *= 1.0 + rng.normal(0, 0.004)
            h *= 1.0 + rng.normal(0, 0.004)
            c = pos + rng.normal(0, 2.0, 2)  # detector jitter
            rows.append(
                [t, c[0] - w / 2, c[1] - h / 2, c[0] + w / 2, c[1] + h / 2]
            )
        out.append(np.asarray(rows, np.float64))
    return out


def make_pairs(rng, trajs, n_pos: int, n_neg: int):
    """-> (fa, ma, fb, mb, labels) numpy batches."""
    fas, mas, fbs, mbs, ys = [], [], [], [], []

    def add(a, b, y):
        fa, ma, fb, mb = pair_features(a, b)
        fas.append(fa)
        mas.append(ma)
        fbs.append(fb)
        mbs.append(mb)
        ys.append(y)

    t_len = len(trajs[0])
    ends = np.asarray([tr[-1, 1:3] for tr in trajs])
    for _ in range(n_pos):
        tr = trajs[rng.integers(len(trajs))]
        cut = int(rng.integers(40, t_len - 40))
        gap = int(rng.integers(1, 31))
        a = tr[max(0, cut - 45) : cut]
        b = tr[min(cut + gap, t_len - 5) :][:45]
        if len(a) < 2 or len(b) < 2:
            continue
        add(a, b, 1.0)
    for k in range(n_neg):
        i = int(rng.integers(len(trajs)))
        a_tr = trajs[i]
        if k % 2 == 0:  # hard negative: nearest other trajectory
            d = np.linalg.norm(ends - ends[i], axis=1)
            d[i] = np.inf
            j = int(np.argmin(d))
        else:
            j = int(rng.integers(len(trajs)))
            if j == i:
                j = (j + 1) % len(trajs)
        b_tr = trajs[j]
        cut = int(rng.integers(40, t_len - 40))
        gap = int(rng.integers(1, 31))
        a = a_tr[max(0, cut - 45) : cut]
        # shift b's frames so the gap is plausible (negatives must be
        # temporally linkable, else the linker never sees them anyway)
        b = b_tr[min(cut, t_len - 45) :][:45].copy()
        b[:, 0] += (a[-1, 0] + gap) - b[0, 0]
        if len(a) < 2 or len(b) < 2:
            continue
        add(a, b, 0.0)
    return (
        np.stack(fas),
        np.stack(mas),
        np.stack(fbs),
        np.stack(mbs),
        np.asarray(ys, np.float32),
    )


def train_step(model: AFLink, opt: torch.optim.Optimizer, fa, ma, fb, mb,
               y) -> torch.Tensor:
    """One Adam step on the mean BCE with logits of a batch -> the loss
    before the step (on the device; reading it waits for the step)."""
    with no_tf32():
        loss = F.binary_cross_entropy_with_logits(model(fa, ma, fb, mb), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return loss.detach()


def accuracy(model: AFLink, fa, ma, fb, mb, y) -> float:
    """Share of pairs whose logit's sign gives the label."""
    with torch.no_grad(), no_tf32():
        logits = model(fa, ma, fb, mb)
    return float(((logits > 0) == (y > 0.5)).float().mean())


def main(argv=None) -> dict:
    """-> {"losses": [(step, loss), ...] at the logged steps, "val_acc",
    "seconds" (the training loop's, data made before it)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    rng = np.random.default_rng(args.seed)
    trajs = make_trajectories(rng, 80)
    train = make_pairs(rng, trajs, 6000, 6000)
    vtrajs = make_trajectories(rng, 20)
    val = make_pairs(rng, vtrajs, 1000, 1000)
    y = train[-1]
    print(f"train pairs {len(y)} (pos {int(y.sum())}), val {len(val[-1])}")
    train = [torch.from_numpy(a).to(device) for a in train]
    val = [torch.from_numpy(a).to(device) for a in val]

    model = init_aflink(torch.Generator().manual_seed(args.seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    t0 = time.perf_counter()
    n = len(y)
    losses, va = [], 0.0
    for it in range(args.steps):
        sel = torch.from_numpy(rng.integers(0, n, args.batch)).to(device)
        loss = train_step(model, opt, *(a[sel] for a in train))
        if it % 200 == 0 or it == args.steps - 1:
            va = accuracy(model, *val)
            losses.append((it, float(loss)))
            print(
                f"step {it}: loss {float(loss):.4f} val_acc {va:.4f} "
                f"({time.perf_counter()-t0:.0f}s)",
                flush=True,
            )
    seconds = time.perf_counter() - t0
    save_aflink(args.out, model)
    print(f"saved {args.out} (val_acc {va:.4f})")
    return {"losses": losses, "val_acc": va, "seconds": seconds}


if __name__ == "__main__":
    main()
