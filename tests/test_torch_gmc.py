"""The port's camera-motion compensation (``track/gmc_flow.py``, K5's plain
version ``ops/cuda/lk_kernel.py``) against the JAX package's
``track/gmc_tpu.py`` and its Pallas LK kernel (interpret mode), and the
synthetic-motion oracles of ``tests/test_gmc_tpu.py`` run on the port.

Tolerances, with their reasons:

- ``frame_to_gray``, ``_pool2`` and ``_blur`` round each product and
  sum where the JAX functions (run op by op) do: equal, bit for bit.
- The plain LK against ``lk_pyramid_pallas``/``lk_level_pallas``
  (interpret mode): the same arithmetic with sums taken in another
  order; 1e-4 base px on the translation and 1e-6 on the linear part
  (seen: under 1e-6 px and 1e-9 on converged pans, 7.2e-6 px and
  1.6e-7 on the unconverged affine case). A wrong damping constant or one Gauss-Newton
  step too few or too many moves the unconverged case by far more
  (``test_lk_plain_unconverged_is_sensitive``).
- ``estimate_warp`` against ``estimate_warp(method="xla")``: that path
  samples with a wider mask and takes gradients of an edge-replicated
  warped image, so it drifts from the TPU kernel's math, which the port
  follows, by up to 0.15 px (the bound of ``tests/test_gmc_tpu.py``).
- A batch of N pairs against N single calls: the per-pair sums run in
  another order, 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops.pallas.lk_kernel import lk_level_pallas, lk_pyramid_pallas
from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import (
    MAX_SHIFT,
    lk_level_plain,
    lk_pyramid,
    lk_pyramid_plain,
)
from strongsort_yolo_tpu_torch.track.gmc_flow import (
    _ITERS_BY_LEVEL,
    BASE_H,
    BASE_W,
    FlowGMC,
    _blur,
    _pool2,
    batched_warps,
    estimate_warp,
    frame_to_gray,
    pyramid,
)

J = importlib.import_module("strongsort_yolo_tpu.track.gmc_tpu")
LK = importlib.import_module("strongsort_yolo_tpu_torch.ops.cuda.lk_kernel")

# (dx, dy) pans of the batched cases; the sixth pair is noisy, so the
# trimming threshold is active
SHIFTS = [(0, 0), (5, -3), (-2, 4), (11, 7), (-20, -9), (1, 1)]
IDENT = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _smooth_image(seed=0, h=BASE_H, w=BASE_W) -> np.ndarray:
    """Periodic sum of sinusoids: np.roll is an exact translation."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(12):
        fy = rng.integers(1, 6) / h
        fx = rng.integers(1, 6) / w
        ph = rng.uniform(0, 2 * np.pi)
        img += rng.uniform(10, 40) * np.sin(2 * np.pi * (fx * x + fy * y) + ph)
    return img + 128.0


@pytest.fixture(scope="module")
def pairs():
    """(N, BASE_H, BASE_W) previous and current grays, pair k panned by
    SHIFTS[k]."""
    rng = np.random.default_rng(1)
    prev, cur = [], []
    for k, (dx, dy) in enumerate(SHIFTS):
        p = _smooth_image(k)
        c = np.roll(p, (dy, dx), axis=(0, 1))
        if k == 5:
            c = c + rng.normal(0, 20, c.shape).astype(np.float32)
        prev.append(p)
        cur.append(c)
    return np.stack(prev), np.stack(cur)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Bilinear sample of one (h, w) image at coordinates of any shape ->
    (values, in-bounds mask as float32): the affine oracle's warp, as
    ``gmc_tpu._sample``."""
    h, w = img.shape
    valid = (xs >= 0.0) & (xs <= w - 1.001) & (ys >= 0.0) & (ys <= h - 1.001)
    xc = xs.clamp(0.0, w - 1.001)
    yc = ys.clamp(0.0, h - 1.001)
    x0, y0 = torch.floor(xc), torch.floor(yc)
    fx, fy = xc - x0, yc - y0
    flat = img.reshape(-1)
    base = y0.long() * w + x0.long()
    top = flat[base] * (1 - fx) + flat[base + 1] * fx
    bot = flat[base + w] * (1 - fx) + flat[base + w + 1] * fx
    return top * (1 - fy) + bot * fy, valid.float()


def _affine(th: float, scale: float, tx: float, ty: float) -> np.ndarray:
    """(2, 3) rotation by ``th`` and scale about the origin, then the
    translation, in base pixels."""
    c, s = scale * np.cos(th), scale * np.sin(th)
    return np.array([[c, -s, tx], [s, c, ty]], np.float32)


def _warped(prev: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """cur sampling prev at a^-1(q): the frame after camera motion a."""
    inv = np.linalg.inv(np.vstack([a, [0, 0, 1]]))[:2]
    gy, gx = np.mgrid[0:BASE_H, 0:BASE_W].astype(np.float32)
    cur, _ = _sample(prev, _t(inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]),
                     _t(inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]))
    return cur


# rotations, scales and pans of the unconverged case: one Gauss-Newton
# step per level leaves each far from the answer
AFFINES = [_affine(0.03, 1.02, 6.0, -4.0), _affine(-0.02, 0.98, -9.0, 5.0),
           _affine(0.01, 1.03, 14.0, 8.0)]
ITERS_ONE = (1, 1, 1)


@pytest.fixture(scope="module")
def affine_pairs():
    """Previous and current grays of AFFINES, as (N, BASE_H, BASE_W)."""
    prev = [_t(_smooth_image(20 + k)) for k in range(len(AFFINES))]
    cur = [_warped(p, a) for p, a in zip(prev, AFFINES)]
    return torch.stack(prev), torch.stack(cur)


def _params(n: int) -> torch.Tensor:
    return torch.tensor(IDENT).repeat(n, 1)


def _assert_params_close(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert d[:, [2, 5]].max() * BASE_W / 2 <= 1e-4, d  # base px
    assert d[:, [0, 1, 3, 4]].max() <= 1e-6, d


# -- the image functions ------------------------------------------------


@pytest.mark.parametrize("hw,n", [((240, 320), 2), ((108, 192), 2),
                                  ((360, 640), 1), ((1080, 1920), 1)])
def test_frame_to_gray_matches_jax(hw, n):
    frames = np.random.default_rng(hw[0]).integers(0, 256, (n, *hw, 3),
                                                   dtype=np.uint8)
    got = frame_to_gray(torch.from_numpy(frames)).numpy()
    want = np.asarray(J.frame_to_gray(jnp.asarray(frames)))
    assert got.shape == (n, BASE_H, BASE_W) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= 255.0


def test_pool_and_blur_match_jax():
    img = np.random.default_rng(2).uniform(0, 255, (BASE_H, BASE_W)).astype(
        np.float32)
    x = torch.from_numpy(img)[None]
    np.testing.assert_array_equal(_pool2(x)[0].numpy(),
                                  np.asarray(J._pool2(jnp.asarray(img))))
    np.testing.assert_array_equal(_blur(x)[0].numpy(),
                                  np.asarray(J._blur(jnp.asarray(img))))
    half = _pool2(x)[0]
    np.testing.assert_array_equal(
        _pool2(half[None])[0].numpy(),
        np.asarray(J._pool2(jnp.asarray(half.numpy()))))


# -- K5's plain version against the TPU kernel --------------------------


def test_lk_pyramid_plain_matches_pallas(pairs):
    prev, cur = pairs
    pp, pc = pyramid(_t(prev)), pyramid(_t(cur))
    got = lk_pyramid_plain(pp, pc, _params(len(SHIFTS)), _ITERS_BY_LEVEL)
    _assert_params_close(got.numpy(),
                         _pallas_pyramid(pp, pc, _ITERS_BY_LEVEL))
    # the pans come back (base px = params * w / 2)
    t = got.numpy()[:5, [2, 5]] * BASE_W / 2
    np.testing.assert_allclose(t, np.array(SHIFTS[:5], np.float32), atol=0.05)
    # the CPU wrapper is the plain version, and counts no launch
    before = lk_pyramid.launches
    np.testing.assert_array_equal(
        lk_pyramid(pp, pc, _params(len(SHIFTS)), _ITERS_BY_LEVEL).numpy(),
        got.numpy())
    assert lk_pyramid.launches == before


def _pallas_pyramid(pp, pc, iters_by_level) -> np.ndarray:
    return np.stack([
        np.asarray(lk_pyramid_pallas(
            tuple(jnp.asarray(lvl[n].numpy()) for lvl in pp),
            tuple(jnp.asarray(lvl[n].numpy()) for lvl in pc),
            jnp.asarray(IDENT, jnp.float32), m=MAX_SHIFT,
            iters_by_level=iters_by_level, interpret=True))
        for n in range(pp[0].shape[0])
    ])


def test_lk_pyramid_plain_matches_pallas_unconverged(affine_pairs):
    """Rotated and scaled pairs with one step per level: every step's
    arithmetic (blend, mask, trimming, damping, solve) shows in the
    result, which is still far from the answer."""
    prev, cur = affine_pairs
    pp, pc = pyramid(prev), pyramid(cur)
    got = lk_pyramid_plain(pp, pc, _params(len(AFFINES)), ITERS_ONE)
    _assert_params_close(got.numpy(), _pallas_pyramid(pp, pc, ITERS_ONE))
    done = lk_pyramid_plain(pp, pc, _params(len(AFFINES)), _ITERS_BY_LEVEL)
    assert (got - done).abs()[:, [2, 5]].max() * BASE_W / 2 > 0.1


@pytest.mark.parametrize("mutation", ["damping x10", "damping x0.1",
                                      "one step fewer", "one step more"])
def test_lk_plain_unconverged_is_sensitive(affine_pairs, mutation,
                                           monkeypatch):
    """The unconverged case tells a wrong kernel from a right one: each
    mutation moves the result past the 1e-4 px / 1e-6 tolerance that
    the kernel and the plain version are held to."""
    prev, cur = affine_pairs
    pp, pc = pyramid(prev), pyramid(cur)
    p0 = _params(len(AFFINES))
    good = lk_pyramid_plain(pp, pc, p0, ITERS_ONE).numpy()
    iters = ITERS_ONE
    if mutation.startswith("damping"):  # scale the solve's damp argument
        scale, solve = float(mutation.split("x")[1]), LK._solve6
        monkeypatch.setattr(LK, "_solve6",
                            lambda h, g, damp: solve(h, g, damp * scale))
    else:
        iters = (0, 1, 1) if mutation == "one step fewer" else (2, 1, 1)
    bad = lk_pyramid_plain(pp, pc, p0, iters).numpy()
    d = np.abs(bad - good)
    assert d[:, [2, 5]].max() * BASE_W / 2 > 1e-3 or d[:, [0, 1, 3, 4]].max() > 1e-5


@pytest.mark.parametrize("level,iters", [(0, 2), (2, 8)])
def test_lk_level_plain_matches_pallas(pairs, level, iters):
    prev, cur = pairs
    sel = [1, 3, 5]  # a small pan, a large one, the noisy pair
    pp = pyramid(_t(prev[sel]))[level]
    pc = pyramid(_t(cur[sel]))[level]
    start = torch.tensor([[1.0, 0.0, 0.03, 0.0, 1.0, -0.02]]).repeat(3, 1)
    got = lk_level_plain(pp, pc, start, iters)
    want = np.stack([
        np.asarray(lk_level_pallas(
            jnp.asarray(pp[n].numpy()), jnp.asarray(pc[n].numpy()),
            jnp.asarray(start[n].numpy()), m=MAX_SHIFT, iters=iters,
            interpret=True))
        for n in range(3)
    ])
    _assert_params_close(got.numpy(), want)


def test_estimate_warp_matches_xla_path(pairs):
    prev, cur = pairs
    got = estimate_warp(_t(prev), _t(cur)).numpy()
    want = np.stack([
        np.asarray(J.estimate_warp(jnp.asarray(prev[n]), jnp.asarray(cur[n]),
                                   method="xla"))
        for n in range(len(SHIFTS))
    ])
    assert got.shape == (len(SHIFTS), 2, 3)
    np.testing.assert_allclose(got, want, atol=0.15)


def test_batch_equals_single_calls(pairs):
    prev, cur = pairs
    batch = estimate_warp(_t(prev), _t(cur), scale_x=6.0, scale_y=6.0)
    for n in range(len(SHIFTS)):
        one = estimate_warp(_t(prev[n:n + 1]), _t(cur[n:n + 1]), scale_x=6.0,
                            scale_y=6.0)
        assert one.shape == (1, 2, 3)
        np.testing.assert_allclose(one[0].numpy(), batch[n].numpy(), atol=1e-6)


# -- the synthetic-motion oracles of tests/test_gmc_tpu.py --------------


def test_identity_on_static_frame():
    img = _t(_smooth_image(1))[None]
    w = estimate_warp(img, img)[0].numpy()
    np.testing.assert_allclose(w[:, :2], np.eye(2), atol=2e-3)
    assert np.abs(w[:, 2]).max() < 0.1


def test_recovers_pure_translation():
    prev = _smooth_image(2)
    dx, dy = 5, -3
    w = estimate_warp(_t(prev)[None],
                      _t(np.roll(prev, (dy, dx), axis=(0, 1)))[None])
    w = w[0].numpy()
    np.testing.assert_allclose(w[:, :2], np.eye(2), atol=5e-3)
    np.testing.assert_allclose(w[0, 2], dx, atol=0.35)
    np.testing.assert_allclose(w[1, 2], dy, atol=0.35)


def test_recovers_small_affine():
    """cur samples prev at W^-1(q) for a small rotation + translation W."""
    prev = _t(_smooth_image(3))
    a = _affine(0.02, 1.0, 3.0, -2.0)
    cur = _warped(prev, a)
    w = estimate_warp(prev[None], cur[None])[0].numpy()
    np.testing.assert_allclose(w[:, :2], a[:, :2], atol=8e-3)
    np.testing.assert_allclose(w[:, 2], a[:, 2], atol=0.6)


def test_sample_matches_jax():
    img = _smooth_image(8)
    rng = np.random.default_rng(8)
    xs = rng.uniform(-3, BASE_W + 3, (40, 50)).astype(np.float32)
    ys = rng.uniform(-3, BASE_H + 3, (40, 50)).astype(np.float32)
    got_v, got_m = _sample(_t(img), _t(xs), _t(ys))
    want_v, want_m = J._sample(jnp.asarray(img), jnp.asarray(xs),
                               jnp.asarray(ys))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4)


def test_scale_back_to_original_coords():
    prev = _smooth_image(4)
    cur = np.roll(prev, (0, 4), axis=(0, 1))
    w = estimate_warp(_t(prev)[None], _t(cur)[None], scale_x=3.0,
                      scale_y=3.0)[0].numpy()
    np.testing.assert_allclose(w[0, 2], 12.0, atol=1.0)


def test_scale_back_matches_jax_anisotropic():
    """Unequal scales: the linear part is conjugated by diag(sx, sy)
    (a12 * sx / sy, a21 * sy / sx), as in the JAX package."""
    prev = _smooth_image(3)
    cur = _warped(_t(prev), _affine(0.02, 1.0, 3.0, -2.0))
    got = estimate_warp(_t(prev)[None], cur[None], scale_x=6.0,
                        scale_y=4.0)[0].numpy()
    want = np.asarray(J.estimate_warp(
        jnp.asarray(prev), jnp.asarray(cur.numpy()), scale_x=6.0, scale_y=4.0,
        method="pallas_interpret"))
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=6e-2)


def test_flow_gmc_protocol(rng):
    g = FlowGMC(device="cpu")
    frame = rng.integers(0, 255, (360, 640, 3), dtype=np.uint8)
    w0 = g.apply(frame)
    np.testing.assert_array_equal(w0, np.eye(2, 3, dtype=np.float32))
    w1 = g.apply(frame)  # static scene -> ~identity
    assert w1.shape == (2, 3) and w1.dtype == np.float32
    np.testing.assert_allclose(w1[:, :2], np.eye(2), atol=5e-3)
    g.reset()
    np.testing.assert_array_equal(g.apply(frame),
                                  np.eye(2, 3, dtype=np.float32))


def test_batched_warps_has_prev_mask():
    prev = np.stack([_smooth_image(5), _smooth_image(6)])
    cur = np.roll(prev, 3, axis=2)
    warps = batched_warps(_t(prev), _t(cur), (BASE_H, BASE_W),
                          has_prev=torch.tensor([True, False])).numpy()
    np.testing.assert_allclose(warps[0, 0, 2], 3.0, atol=0.35)
    np.testing.assert_array_equal(warps[1], np.eye(2, 3, dtype=np.float32))


def test_first_tick_zero_prev_stays_finite():
    """A stream's first tick estimates against a zero gray and selects
    the identity: nothing non-finite comes through the select."""
    cur = _t(np.stack([_smooth_image(9), np.zeros((BASE_H, BASE_W))]))
    warps = batched_warps(torch.zeros_like(cur), cur, (1080, 1920),
                          has_prev=torch.tensor([False, False]))
    np.testing.assert_array_equal(warps.numpy(),
                                  np.tile(np.eye(2, 3), (2, 1, 1)))
