"""AFLink — learned appearance-free tracklet linking.

Counterpart of ``strongsort_yolo_tpu/track/aflink.py``. The StrongSORT++
paper's AFLink scores whether tracklet A (earlier) and tracklet B
(later) belong to the same object from MOTION ONLY: a small temporal-conv
network over the tail of A and the head of B. ``make_cost_fn`` scores
every candidate pair of a sequence in one batched forward, pluggable
into ``track.postprocess.link_tracklets`` via ``cost_fn``.

Input features are scale/translation invariant, so one trained net
works at any resolution: for a pair, positions are centered on the
midpoint between A's last and B's first box center and divided by the
pair's mean box size; time is relative to A's end, divided by the
30-frame link horizon (B's time channel thereby encodes the gap).
Each of the K=30 rows is [t_rel, cx, cy, w, h] (+ a validity mask for
short tracklets).

Architecture (~13k params): a shared two-layer temporal conv encoder
(5->32->32, k=3) with masked mean+max pooling, then an MLP head on
the concatenated pair embedding -> link logit. Cost returned to the
linker is ``1 - sigmoid(logit)``, so ``link_thresh`` keeps its meaning
(lower = better, default 0.8).

Checkpoints are the JAX package's ``.npz`` layout (keys ``c1/w`` ...
``h2/b``, conv weights (width, in, out), dense weights (in, out)), so the
shipped ``assets/aflink_synth.npz`` (trained by ``tools/train_aflink.py``)
loads in both packages. The forward runs in float32 with TF32 off: a
link cost near ``link_thresh`` must fall on the CPU's side of it.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

K = 30  # rows per tracklet segment (AFLink horizon)
HORIZON = 30.0  # time normalization / max linkable gap, frames
FEAT = 5  # [t_rel, cx, cy, w, h]

_CONVS = ("c1", "c2")
_DENSES = ("h1", "h2")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class AFLink(nn.Module):
    """Pair logits: two 'same' temporal convs 5->32->32 with ReLU, masked
    mean and max pooling per tracklet, an MLP 128->64->1 on the pair."""

    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv1d(FEAT, 32, 3, padding=1)
        self.c2 = nn.Conv1d(32, 32, 3, padding=1)
        self.h1 = nn.Linear(128, 64)
        self.h2 = nn.Linear(64, 1)

    def encode(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(N, K, FEAT), (N, K) -> (N, 64) masked mean+max pooled."""
        h = F.relu(self.c1(x.transpose(1, 2)))
        h = F.relu(self.c2(h))  # (N, 32, K)
        m = mask[:, None, :]
        cnt = torch.clamp(m.sum(2), min=1.0)
        mean = (h * m).sum(2) / cnt
        mx = torch.where(m > 0, h, -1e9).amax(2)
        mx = torch.where(cnt > 0, mx, 0.0)
        return torch.cat([mean, mx], -1)

    def forward(self, fa, ma, fb, mb) -> torch.Tensor:
        """Batched pair logits: (N,K,FEAT)x2 (+masks) -> (N,)."""
        z = torch.cat([self.encode(fa, ma), self.encode(fb, mb)], -1)
        z = F.relu(self.h1(z))
        return self.h2(z)[:, 0]


def init_aflink(generator: torch.Generator) -> AFLink:
    """Fresh weights drawn as the JAX ``init_aflink`` draws them (normal
    scaled by 1/sqrt(fan-in), zero biases), from ``generator``."""
    model = AFLink()
    with torch.no_grad():
        for layer in (model.c1, model.c2, model.h1, model.h2):
            fan_in = layer.weight[0].numel()
            layer.weight.normal_(generator=generator).mul_(1.0 / np.sqrt(fan_in))
            layer.bias.zero_()
    return model


@contextlib.contextmanager
def no_tf32():
    """cuDNN convs and cuBLAS matmuls in full float32 within the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def aflink_logits(model: AFLink, fa, ma, fb, mb) -> np.ndarray:
    """Host float32 batches (N, K, FEAT), (N, K) x2 -> (N,) host logits,
    one forward on the model's device, float32 without TF32."""
    dev = next(model.parameters()).device
    with torch.no_grad(), no_tf32():
        out = model(*(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                      for a in (fa, ma, fb, mb)))
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# Pair featurization (host numpy — offline tool path)
# ---------------------------------------------------------------------------


def _segment(rows: np.ndarray, tail: bool) -> np.ndarray:
    """Last/first K rows of a (n, >=5) [frame, x1, y1, x2, y2, ...]."""
    seg = rows[-K:] if tail else rows[:K]
    out = np.zeros((K, FEAT + 1), np.float32)  # + mask column
    n = len(seg)
    c = (seg[:, 1:3] + seg[:, 3:5]) / 2.0
    wh = seg[:, 3:5] - seg[:, 1:3]
    out[:n, 0] = seg[:, 0]
    out[:n, 1:3] = c
    out[:n, 3:5] = wh
    out[:n, 5] = 1.0
    return out


def pair_features(a: np.ndarray, b: np.ndarray):
    """Tracklets a (earlier), b (later) -> (fa, ma, fb, mb) for one
    pair, in the normalized frame described in the module docstring."""
    sa = _segment(a, tail=True)
    sb = _segment(b, tail=False)
    ta_end = a[-1, 0]
    ca = (a[-1, 1:3] + a[-1, 3:5]) / 2.0
    cb = (b[0, 1:3] + b[0, 3:5]) / 2.0
    origin = (ca + cb) / 2.0
    size = max(
        float(
            np.mean(
                [a[-1, 3] - a[-1, 1], a[-1, 4] - a[-1, 2],
                 b[0, 3] - b[0, 1], b[0, 4] - b[0, 2]]
            )
        ),
        1.0,
    )

    def norm(seg):
        f = np.zeros((K, FEAT), np.float32)
        m = seg[:, 5]
        f[:, 0] = (seg[:, 0] - ta_end) / HORIZON * m
        f[:, 1:3] = (seg[:, 1:3] - origin) / size * m[:, None]
        f[:, 3:5] = seg[:, 3:5] / size * m[:, None]
        return f, m.astype(np.float32)

    fa, ma = norm(sa)
    fb, mb = norm(sb)
    return fa, ma, fb, mb


def make_cost_fn(model: AFLink):
    """-> cost_fn(ordered_tracklets: list[np.ndarray]) -> (n, n) cost
    matrix for ``link_tracklets``: one forward over every ordered pair
    on the model's device; pairs with non-positive or over-horizon gaps
    get the linker's 'implausible' cost (10.0). The sigmoid and the cost
    are computed on the host, as in the JAX package."""

    def cost_fn(tracks_list):
        n = len(tracks_list)
        cost = np.full((n, n), 10.0, np.float32)
        idx, fas, mas, fbs, mbs = [], [], [], [], []
        for i, a in enumerate(tracks_list):
            for j, b in enumerate(tracks_list):
                if i == j:
                    continue
                gap = b[0, 0] - a[-1, 0]
                if gap <= 0 or gap > HORIZON:
                    continue
                fa, ma, fb, mb = pair_features(a, b)
                idx.append((i, j))
                fas.append(fa)
                mas.append(ma)
                fbs.append(fb)
                mbs.append(mb)
        if not idx:
            return cost
        logits = aflink_logits(model, np.stack(fas), np.stack(mas),
                               np.stack(fbs), np.stack(mbs))
        p = 1.0 / (1.0 + np.exp(-np.clip(logits, -30.0, 30.0)))
        for (i, j), prob in zip(idx, p):
            cost[i, j] = 1.0 - prob
        return cost

    return cost_fn


# ---------------------------------------------------------------------------
# Checkpoint IO
# ---------------------------------------------------------------------------


def conv_weight(w) -> torch.Tensor:
    """A JAX conv weight (width, in, out) -> torch's (out, in, width)."""
    return torch.tensor(np.asarray(w, np.float32).transpose(2, 1, 0))


def aflink_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """A JAX AFLink parameter tree ({"c1": {"w", "b"}, ...}, arrays as
    numpy) -> a state_dict of :class:`AFLink`."""
    sd = {}
    for name in _CONVS + _DENSES:
        w = tree[name]["w"]
        sd[f"{name}.weight"] = (
            conv_weight(w) if name in _CONVS
            else torch.tensor(np.asarray(w, np.float32).T))
        sd[f"{name}.bias"] = torch.tensor(np.asarray(tree[name]["b"],
                                                     np.float32))
    return sd


def save_aflink(path: str, model: AFLink) -> None:
    """Write ``model`` in the JAX package's ``.npz`` layout."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in
          model.state_dict().items()}
    flat = {}
    for name in _CONVS + _DENSES:
        w = sd[f"{name}.weight"]
        flat[f"{name}/w"] = w.transpose(2, 1, 0) if name in _CONVS else w.T
        flat[f"{name}/b"] = sd[f"{name}.bias"]
    np.savez(path, **flat)


def load_aflink(path: str, device: torch.device | str = "cuda") -> AFLink:
    """An AFLink ``.npz`` (the JAX package's layout) -> the model on
    ``device``, in eval mode."""
    z = np.load(path)
    tree: dict = {}
    for name in z.files:
        k, kk = name.split("/")
        tree.setdefault(k, {})[kk] = z[name]
    model = AFLink()
    model.load_state_dict(aflink_params_from_jax(tree))
    return model.to(device).eval()


def default_checkpoint() -> str:
    """The shipped checkpoint, ``assets/aflink_synth.npz``."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "assets",
        "aflink_synth.npz",
    )
