"""Train OSNet x0_25 on synthetic person-like identities.

Counterpart of the repo's ``tools/train_osnet.py`` for the port's
unfused ``OSNet`` (``models/osnet.py``): the same identities, views,
batches and evaluation, draw for draw from ``--seed``; the same Adam
(lr 3e-4) on the softmax cross-entropy of ``feats @ head * 16`` (the
normed-feature scale) over the identities, every tensor of the
checkpoint trained, the BN statistics included, as the JAX tool's
``optax.adam`` trains every leaf of its tree. The initial weights come
from ``init_osnet`` and the head from N(0, 0.02²), each from a
``torch.Generator`` (seeded ``--seed`` and ``--seed + 2``; the JAX PRNG
cannot be replayed).

Identities are "clothing recipes" (``utils/reid_synth``: the tool's
``make_recipe``, ``render_view``, ``make_dataset`` and ``rank1``): a
3-band (head/torso/legs) 128x64 crop where each band has its own base
color and stripe texture; views of one identity vary by roll, flip,
brightness/contrast and noise. Retrieval quality is the rank-1 of cosine
retrieval on 24 UNSEEN identities, the property StrongSORT's appearance
term uses.

Usage:
    python -m strongsort_yolo_tpu_torch.tools.train_osnet [--out PATH]
        [--seed 0] [--steps 1200] [--ids 96] [--device cuda]

``--out`` defaults to ``build/osnet_x0_25_synth.npz`` (git-ignored); the
shipped ``assets/osnet_x0_25_synth.npz`` is the JAX tool's and is not
overwritten here. The file is the JAX package's OSNet ``.npz``, which
both packages load.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from strongsort_yolo_tpu_torch.utils.reid_synth import (  # noqa: F401
    make_dataset, make_recipe, rank1, render_view,
)


def ce_loss(model, head, crops, labels):
    """The JAX tool's loss: softmax cross-entropy of ``feats @ head * 16``
    over the identities, ``crops`` (N, 128, 64, 3) NHWC in [0, 1]."""
    import torch.nn.functional as F

    feats = model(crops.permute(0, 3, 1, 2))
    return F.cross_entropy(feats @ head * 16.0, labels)


def datasets(seed: int, ids: int, views: int, device):
    """-> (training crops, labels, unseen-id crops (24 ids x 8 views),
    their labels as numpy, the generator the batches are drawn from): the
    tool's data of ``seed``, tensors on ``device``."""
    import torch

    rng = np.random.default_rng(seed)
    x, y, _ = make_dataset(rng, ids, views)
    # unseen-identity eval set (the property the tracker uses)
    ev_x, ev_y, _ = make_dataset(np.random.default_rng(seed + 1), 24, 8)
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).long().to(
        device), torch.from_numpy(ev_x).to(device), ev_y, rng)


def fit(model, head, data, *, steps: int, batch: int) -> dict:
    """Train ``model`` (an unfused OSNet) and ``head`` (feat_dim, ids) with
    Adam (lr 3e-4) on every tensor of both, the BN statistics included,
    the rank-1 on the unseen ids every 150 steps and at the last ->
    {"losses": [(step, loss), ...], "rank1": [(step, rank-1), ...],
    "rank1_init" (before training), "seconds" (the loop's, evaluations
    included)}."""
    import torch

    from strongsort_yolo_tpu_torch.train.trainer import (
        exact_step, trained_tensors,
    )
    from strongsort_yolo_tpu_torch.utils.transfer import to_device

    xd, yd, ev, ev_y, rng = data
    head.requires_grad_(True)
    opt = torch.optim.Adam(trained_tensors(model) + [head], lr=3e-4)

    def eval_rank1() -> float:
        with torch.no_grad(), exact_step():
            out = [model(ev[i : i + 64].permute(0, 3, 1, 2))
                   for i in range(0, len(ev), 64)]
        return rank1(torch.cat(out).cpu().numpy(), ev_y)

    r0 = eval_rank1()
    print(f"initial rank-1 on unseen ids: {r0:.4f}", flush=True)
    t0 = time.perf_counter()
    losses, ranks = [], []
    for it in range(steps):
        idx = to_device(rng.integers(0, len(yd), batch), xd.device)
        with exact_step():
            loss = ce_loss(model, head, xd[idx], yd[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
        opt.step()
        if it % 150 == 0 or it == steps - 1:
            losses.append((it, float(loss.detach())))
            ranks.append((it, eval_rank1()))
            print(
                f"step {it}: loss {losses[-1][1]:.4f} "
                f"unseen-id rank-1 {ranks[-1][1]:.4f} "
                f"({time.perf_counter()-t0:.0f}s)",
                flush=True,
            )
    return {"losses": losses, "rank1": ranks, "rank1_init": r0,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    """-> :func:`fit`'s dict for the tool's recipe (the checkpoint is
    written to ``--out``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--ids", type=int, default=96)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "osnet_x0_25_synth.npz"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from strongsort_yolo_tpu_torch.models.osnet import (
        OSNet, OsnetConfig, init_osnet,
    )
    from strongsort_yolo_tpu_torch.models.porting import save_osnet_npz

    device = torch.device(args.device)
    data = datasets(args.seed, args.ids, args.views, device)
    print(f"train {len(data[1])} crops / {args.ids} ids; eval 24 unseen ids")
    cfg = OsnetConfig()
    model = OSNet(cfg, fused=False)
    model.load_state_dict(init_osnet(cfg, torch.Generator().manual_seed(
        args.seed)))
    head = torch.randn((cfg.feat_dim, args.ids), generator=torch.Generator()
                       .manual_seed(args.seed + 2)) * 0.02
    res = fit(model.to(device), head.to(device), data, steps=args.steps,
              batch=args.batch)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    save_osnet_npz(args.out, model.state_dict(), cfg)
    print(f"saved {args.out} (unseen rank-1 {res['rank1'][-1][1]:.4f} vs "
          f"initial {res['rank1_init']:.4f})")
    return res


if __name__ == "__main__":
    main()
