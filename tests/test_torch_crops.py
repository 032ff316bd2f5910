"""The port's banded-pyramid crop (``ops/crops.py`` and the plain version
of the K4 kernel, ``ops/cuda/crop_kernel.banded_crop_plain``) against the
JAX package: ``pyramid_dims``, ``banded_prep``, ``build_pyramid``, the
TPU kernel in interpret mode (``banded_crop_packed``, ``banded_crop``) and
the stacked-einsum oracle ``crop_and_resize_pyramid``.

The JAX functions run jitted, as the pipeline runs them: XLA's CPU
backend then contracts a multiply-add into one rounding, which the port
reproduces (``ops/crops.fma32``).

Frames of 600x1000 need two pyramid levels, 1080p three. Tolerances:
level choice (``ints``) exact; the sampling scalars within 1e-6 relative
(same float32 formulas); pyramids and crops in float32 within 1e-6 (the
same products and sums, the JAX contractions may fuse a multiply-add);
against the oracle, whose taps are written as 1 - w and w, 1e-5; bfloat16
within one bf16 unit at 1.0 (2**-7: the JAX contractions round where the
plain version does, but may fuse a multiply-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops import crops as jcrops
from strongsort_yolo_tpu.ops.pallas.crop_kernel import (
    banded_crop as j_banded_crop,
    banded_crop_packed as j_banded_crop_packed,
)
from strongsort_yolo_tpu_torch.ops import crops as tcrops
from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import (
    banded_crop,
    banded_crop_frames,
)

OUT_HW = (128, 64)
BF16_TOL = 2.0**-7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, n, h, w):
    """Boxes for every level, all four frame edges, and degenerate ones."""
    out = []
    for i in range(n):
        frac = (0.1, 0.3, 0.7, 0.98)[i % 4]
        x1 = rng.uniform(-20, w * (1 - frac * 0.5))
        y1 = rng.uniform(-20, h * (1 - frac * 0.5))
        out.append((x1, y1, x1 + rng.uniform(8, frac * w),
                    y1 + rng.uniform(12, frac * h)))
    out += [
        (0, 0, 0, 0), (5, 5, 5, 40), (w - 1, h - 1, w + 30, h + 50),
        (-40, 10, 30, 200), (w - 30, 20, w + 40, 220),
        (100, -50, 160, 30), (40, h - 30, 120, h + 60),
        (0, 0, w, h), (-60, -60, w + 60, h + 60),
    ]
    return np.asarray(out, np.float32)


def _frames(rng, s, h, w):
    return rng.uniform(0, 1, (s, h, w, 3)).astype(np.float32)


def _planar(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).to(dtype)


@pytest.mark.parametrize("hw", [(1080, 1920), (600, 1000), (240, 320),
                                (720, 1280), (2160, 3840), (37, 61)])
def test_pyramid_dims_vs_jax(hw):
    assert tcrops.pyramid_dims(*hw) == jcrops.pyramid_dims(*hw)
    assert tcrops._pad_dims(tcrops.pyramid_dims(*hw)) == jcrops._pad_dims(
        jcrops.pyramid_dims(*hw))


@pytest.mark.parametrize("hw", [(1080, 1920), (600, 1000), (240, 320)])
def test_banded_prep_vs_jax(hw):
    rng = np.random.default_rng(hw[0])
    boxes = _boxes(rng, 200, *hw)
    dims = jcrops.pyramid_dims(*hw)
    prep = jax.jit(jcrops.banded_prep, static_argnums=(1, 2, 3))
    jscal, jints = prep(jnp.asarray(boxes), hw, tuple(dims), OUT_HW)
    tscal, tints = tcrops.banded_prep(torch.from_numpy(boxes), hw, dims, OUT_HW)
    np.testing.assert_array_equal(tints.numpy(), np.asarray(jints))
    np.testing.assert_allclose(tscal.numpy(), np.asarray(jscal), rtol=1e-6,
                               atol=1e-6)
    if len(dims) > 1:  # the boxes really select every level
        assert set(tints[:, 2].tolist()) == set(range(len(dims)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_pyramid_vs_jax(dtype):
    rng = np.random.default_rng(1)
    x = _frames(rng, 2, 600, 1000)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcrops.build_pyramid(jnp.asarray(x, jdt))
    got = tcrops.build_pyramid(_planar(x, dtype))
    assert len(got) == len(want) == 2
    tol = 1e-6 if dtype == torch.float32 else BF16_TOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).float().numpy(),
            np.asarray(w, np.float32), atol=tol,
        )
    stack = tcrops.pyramid_stack(_planar(x, dtype))
    for lv, (h, w), off in zip(got, stack.dims, stack.row_off.tolist()):
        assert torch.equal(stack.stack[:, :, off:off + h, :w], lv)


def _packed(rng, s, h, w):
    """Ragged per-frame boxes packed stream-major, each frame's count
    padded to 8 with the dummy box, plus one all-padding block."""
    per = [_boxes(rng, n, h, w) for n in (5, 13)][:s]
    slots, frames_of, real = [], [], []
    for f, b in enumerate(per):
        pad = -(-len(b) // 8) * 8
        slots.append(np.concatenate(
            [b, np.tile([[0, 0, 16, 32]], (pad - len(b), 1))]))
        frames_of += [f] * pad
        real += [True] * len(b) + [False] * (pad - len(b))
    slots.append(np.tile([[0, 0, 16, 32]], (8, 1)))
    frames_of += [0] * 8
    real += [False] * 8
    return (np.concatenate(slots).astype(np.float32),
            np.asarray(frames_of, np.int32), np.asarray(real))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_crop_vs_jax_kernel(dtype):
    """The plain version of K4 (packed form) against the TPU kernel's own
    arithmetic, interpret mode, frames of two pyramid levels."""
    rng = np.random.default_rng(2)
    s, h, w = 2, 600, 1000
    x = _frames(rng, s, h, w)
    boxes, slot_frame, _ = _packed(rng, s, h, w)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_banded_crop_packed(
        jnp.asarray(x, jdt), jnp.asarray(boxes), jnp.asarray(slot_frame),
        OUT_HW, interpret=True,
    )  # (G, oh, ow, 3) f32
    pyr = tcrops.pyramid_stack(_planar(x, dtype))
    scal, ints = tcrops.banded_prep(torch.from_numpy(boxes), (h, w), pyr.dims,
                                    OUT_HW)
    assert set(ints[:, 2].tolist()) == {0, 1}
    got = banded_crop(pyr, scal, ints, torch.from_numpy(slot_frame), OUT_HW)
    assert got.shape == (len(boxes), 3, *OUT_HW) and got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(want), atol=tol)


def test_fixed_width_crop_vs_jax_kernel_1080p():
    """The fixed-width form (slot b*M + i from frame b) against the TPU
    kernel's ``banded_crop`` at 1080p: three levels."""
    rng = np.random.default_rng(3)
    x = _frames(rng, 1, 1080, 1920)
    boxes = _boxes(rng, 7, 1080, 1920)[None]
    want = j_banded_crop(jnp.asarray(x), jnp.asarray(boxes), OUT_HW,
                         interpret=True)  # (1, M, oh, ow, 3)
    got = banded_crop_frames(_planar(x), torch.from_numpy(boxes), OUT_HW)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(want), atol=1e-6)
    dims = tcrops.pyramid_dims(1080, 1920)
    _, ints = tcrops.banded_prep(torch.from_numpy(boxes[0]), (1080, 1920),
                                 dims, OUT_HW)
    assert set(ints[:, 2].tolist()) == {0, 1, 2}


def test_crop_vs_jax_pyramid_oracle():
    """The plain K4 version and the port's stacked-einsum oracle against
    the JAX oracle ``crop_and_resize_pyramid``."""
    rng = np.random.default_rng(4)
    x = _frames(rng, 1, 600, 1000)
    boxes = _boxes(rng, 9, 600, 1000)
    oracle_fn = jax.jit(jcrops.crop_and_resize_pyramid, static_argnums=2)
    want = np.asarray(oracle_fn(jnp.asarray(x[0]), jnp.asarray(boxes),
                                OUT_HW))  # (M, oh, ow, 3)
    oracle = tcrops.crop_and_resize_pyramid(_planar(x)[0],
                                            torch.from_numpy(boxes), OUT_HW)
    np.testing.assert_allclose(oracle.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)
    got = banded_crop_frames(_planar(x), torch.from_numpy(boxes)[None], OUT_HW)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)


def test_last_row_tap_reads_inside_the_level():
    """A box ending on the level's last row and column: the clipped
    position's second tap (weight 0) must not read past the level, here
    made of NaNs, and the crop matches the JAX kernel."""
    rng = np.random.default_rng(5)
    x = _frames(rng, 1, 240, 320)
    boxes = np.asarray([[200, 150, 340, 260], [319, 239, 400, 300]], np.float32)
    pyr = tcrops.pyramid_stack(_planar(x))
    big = torch.full((1, 3, pyr.stack.shape[2] + 4, pyr.stack.shape[3] + 4),
                     float("nan"))
    big[:, :, :pyr.stack.shape[2], :pyr.stack.shape[3]] = pyr.stack
    h0, w0 = pyr.dims[0]
    big[:, :, h0:, :] = float("nan")
    big[:, :, :, w0:] = float("nan")
    pyr = pyr._replace(stack=big)
    scal, ints = tcrops.banded_prep(torch.from_numpy(boxes), (240, 320),
                                    pyr.dims, OUT_HW)
    got = banded_crop(pyr, scal, ints, torch.zeros(2, dtype=torch.int32),
                      OUT_HW)
    assert torch.isfinite(got).all()
    want = j_banded_crop(jnp.asarray(x), jnp.asarray(boxes)[None], OUT_HW,
                         interpret=True)[0]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6)

