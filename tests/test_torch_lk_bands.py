"""A torch emulation of K5's card design (``csrc/lk_pyramid.cu``): the band
partition of each level over a pair's cluster of thread blocks, each
thread's walk over its band, and the kernel's fixed order of the sums,
against K5's plain version and the TPU LK kernel (interpret mode).

The kernel gives block ``rank`` of a pair's cluster the rows
``[h * rank // C, h * (rank + 1) // C)`` of every level, and each of its
``THREADS`` threads the band's pixels ``q = t, t + THREADS, ...`` in
row-major order, walked by fixed row and column steps. A sum runs over
each thread's pixels in order, then over a warp's 32 threads in lane
order, the block's warps in order and the cluster's ranks in order. The
emulation computes every pixel's values as the plain version does and
only takes the sums in that order, so it agrees with the plain version
and the TPU kernel within the card's tolerance (1e-4 base px on the
translation, 1e-6 on the linear part: the trimming threshold is a step),
and a pair's result does not depend on the batch it is in.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops.pallas.lk_kernel import lk_pyramid_pallas
from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import (
    CLUSTER,
    MAX_SHIFT,
    THREADS,
    lk_pyramid_plain,
)
from strongsort_yolo_tpu_torch.track.gmc_flow import (
    _ITERS_BY_LEVEL,
    BASE_H,
    BASE_W,
    pyramid,
)

LK = importlib.import_module("strongsort_yolo_tpu_torch.ops.cuda.lk_kernel")
SHAPES = [(180, 320), (90, 160), (45, 80), (33, 17)]
IDENT = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def bands(h: int, cluster: int = CLUSTER) -> list[tuple[int, int]]:
    return [(h * r // cluster, h * (r + 1) // cluster) for r in range(cluster)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cluster", [CLUSTER, 8, 16])
def test_bands_and_walks_cover_every_pixel_once(shape, cluster):
    """Each pixel of the level falls in exactly one band, and each band's
    pixels in exactly one thread's walk, at the index q = i * w + j it
    keeps in shared memory; no band has more than ceil(h / C) rows."""
    h, w = shape
    seen = np.zeros((h, w), int)
    i_step, j_step = THREADS // w, THREADS % w
    for r0, r1 in bands(h, cluster):
        assert r1 - r0 <= -(-h // cluster)
        npx = (r1 - r0) * w
        for t in range(THREADS):
            i, j = t // w, t % w
            for q in range(t, npx, THREADS):
                assert i * w + j == q
                seen[r0 + i, j] += 1
                i, j = i + i_step, j + j_step
                if j >= w:
                    i, j = i + 1, j - w
    assert (seen == 1).all()


def ordered_total(x: torch.Tensor) -> torch.Tensor:
    """(N, h, w) float32 -> (N,): the sum in K5's order."""
    n, h, w = x.shape
    rows = -(-h // CLUSTER)
    per_rank = []
    for r0, r1 in bands(h):
        band = torch.zeros(n, rows * w + THREADS, dtype=x.dtype)
        band[:, :(r1 - r0) * w] = x[:, r0:r1].reshape(n, -1)
        per_rank.append(band)
    # (N, rank, pixel k of a thread, thread); a thread's pixels in order
    px = torch.stack(per_rank, 1)
    px = px[:, :, :px.shape[2] // THREADS * THREADS].reshape(
        n, CLUSTER, -1, THREADS)
    acc = torch.zeros(n, CLUSTER, THREADS, dtype=x.dtype)
    for k in range(px.shape[2]):
        acc = acc + px[:, :, k]
    lanes = acc.reshape(n, CLUSTER, THREADS // 32, 32)
    warp = lanes[..., 0]
    for lane in range(1, 32):
        warp = warp + lanes[..., lane]
    block = warp[..., 0]
    for g in range(1, THREADS // 32):
        block = block + warp[..., g]
    total = block[:, 0]
    for r in range(1, CLUSTER):
        total = total + block[:, r]
    return total


@pytest.mark.parametrize("shape", [(45, 80), (33, 17)])
def test_ordered_total_is_the_kernel_order(shape):
    """The vectorised emulation of the order against the kernel's loops
    written out one float32 addition at a time."""
    h, w = shape
    x = torch.from_numpy(np.random.default_rng(h).normal(
        0, 100, (1, h, w)).astype(np.float32))
    f32 = np.float32
    total = None
    for r0, r1 in bands(h):
        flat = x[0, r0:r1].reshape(-1).numpy()
        threads = []
        for t in range(THREADS):
            acc = f32(0)
            for q in range(t, flat.size, THREADS):
                acc = f32(acc + flat[q])
            threads.append(acc)
        warps = []
        for g in range(THREADS // 32):
            acc = threads[32 * g]
            for lane in range(1, 32):
                acc = f32(acc + threads[32 * g + lane])
            warps.append(acc)
        block = warps[0]
        for acc in warps[1:]:
            block = f32(block + acc)
        total = block if total is None else f32(total + block)
    assert ordered_total(x).item() == total


def emulate(prev_levels, cur_levels, params, iters_by_level):
    """K5 coarse to fine, its sums in the kernel's order."""
    p = params.float()
    for lvl in range(len(prev_levels) - 1, -1, -1):
        p = LK._refine_level(prev_levels[lvl], cur_levels[lvl], p,
                             int(iters_by_level[lvl]), total=ordered_total)
    return p


def _smooth(seed: int, h: int = BASE_H, w: int = BASE_W) -> np.ndarray:
    """Periodic sum of sinusoids: np.roll is an exact translation."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w), 128.0, np.float32)
    for _ in range(12):
        fy, fx = rng.integers(1, 6) / h, rng.integers(1, 6) / w
        img += (rng.uniform(10, 40) * np.sin(
            2 * np.pi * (fx * x + fy * y) + rng.uniform(0, 2 * np.pi))
        ).astype(np.float32)
    return img


def _pairs(shifts, noisy=None, seed=0):
    """Previous and current planes, pair k panned by shifts[k]; pair
    ``noisy`` carries noise, so the trimming threshold bites."""
    rng = np.random.default_rng(seed)
    prev, cur = [], []
    for k, (dx, dy) in enumerate(shifts):
        p = _smooth(seed + k)
        c = np.roll(p, (dy, dx), axis=(0, 1))
        if k == noisy:
            c = c + rng.normal(0, 20, c.shape).astype(np.float32)
        prev.append(p)
        cur.append(c)
    return (pyramid(torch.from_numpy(np.stack(prev))),
            pyramid(torch.from_numpy(np.stack(cur))))


def _affine_pairs():
    """Pairs rotated, scaled and panned about the centre: one step per
    level leaves them far from converged, so every step shows."""
    prev, cur = [], []
    y, x = np.mgrid[0:BASE_H, 0:BASE_W].astype(np.float32)
    for k, (th, sc, dx, dy) in enumerate([(0.03, 1.02, 6, -4),
                                          (-0.02, 0.98, -9, 5)]):
        rng = np.random.default_rng(30 + k)
        waves = [(rng.integers(1, 6) / BASE_W, rng.integers(1, 6) / BASE_H,
                  rng.uniform(10, 40), rng.uniform(0, 2 * np.pi))
                 for _ in range(12)]

        def image(xs, ys):
            img = np.full((BASE_H, BASE_W), 128.0, np.float32)
            for fx, fy, amp, ph in waves:
                img += (amp * np.sin(2 * np.pi * (fx * xs + fy * ys) + ph)
                        ).astype(np.float32)
            return img

        cx, cy = (BASE_W - 1) / 2, (BASE_H - 1) / 2
        u, v = x - cx - dx, y - cy - dy
        prev.append(image(x, y))
        cur.append(image((np.cos(th) * u + np.sin(th) * v) / sc + cx,
                         (-np.sin(th) * u + np.cos(th) * v) / sc + cy))
    return (pyramid(torch.from_numpy(np.stack(prev))),
            pyramid(torch.from_numpy(np.stack(cur))))


def _close(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert d[:, [2, 5]].max() * BASE_W / 2 <= 1e-4, d  # base px
    assert d[:, [0, 1, 3, 4]].max() <= 1e-6, d


def _pallas(pp, pc, iters) -> np.ndarray:
    return np.stack([
        np.asarray(lk_pyramid_pallas(
            tuple(jnp.asarray(lvl[n].numpy()) for lvl in pp),
            tuple(jnp.asarray(lvl[n].numpy()) for lvl in pc),
            jnp.asarray(IDENT, jnp.float32), m=MAX_SHIFT,
            iters_by_level=iters, interpret=True))
        for n in range(pp[0].shape[0])
    ])


@pytest.mark.parametrize("case", ["panned", "unconverged"])
def test_emulation_matches_plain_and_pallas(case):
    if case == "panned":
        pp, pc = _pairs([(5, -3), (-12, 7), (1, 1)], noisy=2)
        iters = _ITERS_BY_LEVEL
    else:
        pp, pc = _affine_pairs()
        iters = (1, 1, 1)
    params = torch.tensor(IDENT).repeat(pp[0].shape[0], 1)
    got = emulate(pp, pc, params, iters)
    _close(got, lk_pyramid_plain(pp, pc, params, iters))
    _close(got, _pallas(pp, pc, iters))
    if case == "panned":  # the clean pans come back, in base px
        t = got.numpy()[:2, [2, 5]] * BASE_W / 2
        np.testing.assert_allclose(t, [(5, -3), (-12, 7)], atol=0.05)


def test_emulation_on_an_odd_level():
    """One 33 x 17 level (bands of 4 and 5 rows, a thread's walk wrapping
    rows) against the plain version."""
    pp, pc = _pairs([(1, 0), (0, -1)], noisy=1)
    prev = [torch.nn.functional.interpolate(
        pp[1][:, None], size=(33, 17), mode="area")[:, 0]]
    cur = [torch.nn.functional.interpolate(
        pc[1][:, None], size=(33, 17), mode="area")[:, 0]]
    params = torch.tensor([[1.0, 0.0, 0.02, 0.0, 1.0, -0.01]]).repeat(2, 1)
    _close(emulate(prev, cur, params, (4,)),
           lk_pyramid_plain(prev, cur, params, (4,)))


def test_emulated_pair_does_not_depend_on_the_batch():
    pp, pc = _pairs([(3, 2), (-6, 1), (0, 4)], noisy=1, seed=5)
    params = torch.tensor(IDENT).repeat(3, 1)
    batch = emulate(pp, pc, params, _ITERS_BY_LEVEL)
    for k in range(3):
        one = emulate([x[k:k + 1] for x in pp], [x[k:k + 1] for x in pc],
                      params[k:k + 1], _ITERS_BY_LEVEL)
        assert torch.equal(one[0], batch[k])
