"""Synthetic ReID identities and rank-1 retrieval, the evaluation set of
the trained OSNet (``assets/osnet_x0_25_synth.npz``).

An identity is a clothing recipe: a 128x64 crop of three bands (head,
torso, legs), each with its own colour and stripe texture; views of one
identity differ by a shift, a flip, brightness, contrast and noise.
Rank-1 is leave-one-out cosine retrieval over L2-normed embeddings.
Numpy only; ``make_dataset(np.random.default_rng(999), 16, 8)`` draws
the 16 unseen identities the trained OSNet is held to (rank-1 >= 0.9).
"""

from __future__ import annotations

import numpy as np


def make_recipe(rng: np.random.Generator) -> dict:
    """One identity: the band layout and each band's colour and stripes."""
    head = rng.uniform(0.12, 0.2)
    torso = rng.uniform(0.35, 0.5)
    return {
        "bands": (head, torso),
        "colors": rng.uniform(0.05, 0.95, (3, 3)),
        "stripe_color": rng.uniform(0.0, 1.0, (3, 3)),
        "freq": rng.uniform(0.0, 0.45, 3),  # stripes per row; 0 = plain
        "horiz": rng.random(3) < 0.5,
        "phase": rng.uniform(0, np.pi, 3),
    }


def render_view(rng: np.random.Generator, r: dict, h: int = 128,
                w: int = 64) -> np.ndarray:
    """One augmented view of an identity -> (h, w, 3) float32 in [0, 1]."""
    img = np.empty((h, w, 3), np.float32)
    head, torso = r["bands"]
    edges = [0, int(h * head), int(h * (head + torso)), h]
    yy, xx = np.mgrid[0:h, 0:w]
    for b in range(3):
        sl = slice(edges[b], edges[b + 1])
        base = r["colors"][b][None, None, :]
        if r["freq"][b] > 0.02:
            coord = yy[sl] if r["horiz"][b] else xx[sl]
            s = 0.5 + 0.5 * np.sin(
                coord * r["freq"][b] * 2 * np.pi / 8.0 + r["phase"][b]
            )
            img[sl] = base + (r["stripe_color"][b][None, None, :] - base) * (
                s[..., None] * 0.8
            )
        else:
            img[sl] = base
    # the view: a shift (roll), a flip, brightness and contrast, noise
    dy, dx = rng.integers(-6, 7), rng.integers(-4, 5)
    img = np.roll(img, (dy, dx), axis=(0, 1))
    if rng.random() < 0.5:
        img = img[:, ::-1]
    img = img * rng.uniform(0.7, 1.25) + rng.uniform(-0.08, 0.08)
    img = img + rng.normal(0, 0.04, img.shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def make_dataset(rng: np.random.Generator, n_ids: int, views: int):
    """-> (crops (n_ids * views, 128, 64, 3) float32 NHWC, identity
    labels (n_ids * views,) int32, the recipes)."""
    recipes = [make_recipe(rng) for _ in range(n_ids)]
    x = np.stack(
        [render_view(rng, r) for r in recipes for _ in range(views)]
    )
    y = np.repeat(np.arange(n_ids), views).astype(np.int32)
    return x, y, recipes


def rank1(emb: np.ndarray, y: np.ndarray) -> float:
    """Rank-1 of leave-one-out cosine retrieval (embeddings L2-normed)."""
    sim = emb @ emb.T
    np.fill_diagonal(sim, -2.0)
    return float(np.mean(y[np.argmax(sim, 1)] == y))
