"""Banded-pyramid crop geometry: detection boxes -> ReID crop parameters.

Counterpart of the banded section of ``strongsort_yolo_tpu/ops/crops.py``.
Each crop samples one level of a pyramid of the [0, 1] frame: level 0 is
the frame at half size, each further level a bilinear 2x decimation of
the one before, until a level fits one (BAND_H, BAND_W) band.
:func:`banded_prep` picks each crop's level by the JAX package's rule
(the finest level whose band covers the box; the choice changes the
pixels) and returns the per-crop sampling scalars the K4 kernel
(``ops/cuda/crop_kernel.py``) consumes.

The TPU kernel's band (a (256, 512) window aligned to (8, 128)) is a
tiling device; K4 samples the chosen level directly, so this module
keeps the band only where it decides the level. Pyramids here are
planar, (..., C, H, W), which is the crop kernel's and OSNet's layout;
the JAX functions keep (..., H, W, C).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from strongsort_yolo_tpu_torch.ops.letterbox import _axis_taps

BAND_H = 256  # band rows  (y0 aligned to 8  -> covers spans <= 247)
BAND_W = 512  # band cols  (x0 aligned to 128 -> covers spans <= 383)
DOWNSCALE = 2  # level 0 is the frame at half size (the JAX default)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend contracts a
    multiply-add (the JAX reference computes the crop positions so) and
    as CUDA's ``fmaf`` computes it. The product of two float32 values is
    exact in float64; the sum is rounded to float64, and where that
    rounding lands exactly halfway between two float32 values, rounding
    again would not give the fused result: there the float64 sum is moved
    one step towards the exact one (its TwoSum residual) first."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else float(v)
    p, c64 = f64(a) * f64(b), f64(c)
    s = p + c64
    t = s - p
    err = (p - (s - t)) + (c64 - t)  # exact: a * b + c == s + err
    halfway = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    toward = torch.where(err > 0, math.inf, -math.inf).double()
    return torch.where(halfway & (err != 0), torch.nextafter(s, toward),
                       s).float()


def pyramid_dims(h: int, w: int) -> list[tuple[int, int]]:
    """Level dims: level 0 = (h//DOWNSCALE, w//DOWNSCALE); 2x-decimated
    levels follow until one fits entirely inside a band."""
    dims = [(max(h // DOWNSCALE, 1), max(w // DOWNSCALE, 1))]
    while dims[-1][0] > BAND_H - 8 or dims[-1][1] > BAND_W - 128:
        ph, pw = dims[-1]
        dims.append((max(ph // 2, 1), max(pw // 2, 1)))
    return dims


def _pad_dims(dims):
    """Per level, the padded (rows, cols) the TPU band slides in."""
    return [
        (max(-(-ph // 8) * 8, BAND_H), max(-(-pw // 128) * 128, BAND_W))
        for ph, pw in dims
    ]


@functools.lru_cache(maxsize=64)
def _taps(dst: int, src: int, device: torch.device):
    """One axis's tap indices (int64) and float32 weights on ``device``,
    uploaded once per shape: a copy from pageable memory on every call
    would synchronise the stream."""
    idx, wts = _axis_taps(dst, src)
    lo, hi = (torch.from_numpy(i.astype(np.int64)).to(device) for i in idx)
    w_lo, w_hi = (torch.from_numpy(v).to(device) for v in wts)
    return lo, hi, w_lo, w_hi


def resize_bilinear(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(..., H, W) float -> (..., new_h, new_w) in x's dtype: the
    cv2.INTER_LINEAR resize of the JAX ``resize_bilinear_matmul``, two
    taps per axis, rows first, each pass summed in float32 and rounded
    to x's dtype (as the JAX contraction rounds its output)."""
    h, w = x.shape[-2], x.shape[-1]
    dt, f32 = x.dtype, torch.float32
    if new_h != h:
        lo, hi, w_lo, w_hi = _taps(new_h, h, x.device)
        x = (w_lo[:, None] * x.index_select(-2, lo).to(f32)
             + w_hi[:, None] * x.index_select(-2, hi).to(f32)).to(dt)
    if new_w != w:
        lo, hi, w_lo, w_hi = _taps(new_w, w, x.device)
        x = (w_lo * x.index_select(-1, lo).to(f32)
             + w_hi * x.index_select(-1, hi).to(f32)).to(dt)
    return x


def build_pyramid(images: torch.Tensor) -> list[torch.Tensor]:
    """(..., C, H, W) -> the pyramid levels (..., C, h_l, w_l), each level
    a bilinear resize of the one before (level 0 of the frame itself)."""
    h, w = images.shape[-2], images.shape[-1]
    dims = pyramid_dims(h, w)
    levels = [resize_bilinear(images, *dims[0])]
    for ph, pw in dims[1:]:
        levels.append(resize_bilinear(levels[-1], ph, pw))
    return levels


class PyramidStack(NamedTuple):
    """The pyramid of S frames stacked vertically, planar: level l of
    frame s, channel c is ``stack[s, c, row_off[l]:row_off[l] + h_l,
    :w_l]``; the rest of each row is zero and never read."""

    stack: torch.Tensor  # (S, C, sum h_l, w_0) in the compute dtype
    row_off: torch.Tensor  # (L,) int32, on the stack's device
    dims: list[tuple[int, int]]  # (h_l, w_l) per level
    src_hw: tuple[int, int]  # the frames' (H, W)


@functools.lru_cache(maxsize=64)
def _row_offsets(offs: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(L,) int32 level offsets on ``device``, uploaded once per shape."""
    return torch.tensor(offs, dtype=torch.int32, device=device)


def pyramid_stack(images: torch.Tensor) -> PyramidStack:
    """(S, C, H, W) float frames -> their :class:`PyramidStack`."""
    levels = build_pyramid(images)
    dims = [(lv.shape[-2], lv.shape[-1]) for lv in levels]
    s, c = images.shape[:2]
    offs = np.cumsum([0] + [h for h, _ in dims]).tolist()
    stack = images.new_zeros((s, c, offs[-1], dims[0][1]))
    for lv, (h, w), off in zip(levels, dims, offs):
        stack[:, :, off:off + h, :w] = lv
    return PyramidStack(stack, _row_offsets(tuple(offs[:-1]), images.device),
                        dims, (images.shape[-2], images.shape[-1]))


def banded_prep(boxes: torch.Tensor, src_hw, dims, out_hw):
    """Per-crop sampling parameters. boxes (..., 4) xyxy in source pixels
    -> scal (..., 6) f32 [y_base, y_step, x_base, x_step, h_l, w_l]
    (sample r sits at y_base + r * y_step in the chosen level's pixels)
    and ints (..., 3) i32 [y0, x0, level] (y0/x0: the TPU band's origin
    in the level, 8- and 128-aligned; K4 reads only the level).

    Every constant enters as a float32 tensor and every quotient divides
    by a tensor: PyTorch's CUDA division by a Python scalar multiplies by
    the reciprocal, and the card must pick the same levels as the CPU."""
    f32, i32 = torch.float32, torch.int32
    dev = boxes.device
    H, W = src_hw
    oh, ow = out_hw

    def const(v):  # a fill on the device, not a copy from the host
        return torch.full((), v, dtype=f32, device=dev)

    boxes = boxes.to(f32)
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    size_y = torch.clamp(y2 - y1, min=1e-3)
    size_x = torch.clamp(x2 - x1, min=1e-3)
    oh_t, ow_t, half = const(oh), const(ow), const(0.5)
    sel_scal = sel_ints = done = None
    for lvl, ((hl, wl), (hp, wp)) in enumerate(zip(dims, _pad_dims(dims))):
        sy, sx = const(hl / H), const(wl / W)
        y_step = size_y * sy / oh_t
        y_base = fma32(y1 + half * size_y / oh_t, sy, -0.5)
        x_step = size_x * sx / ow_t
        x_base = fma32(x1 + half * size_x / ow_t, sx, -0.5)
        lo_y = torch.floor(y_base)
        hi_y = torch.floor(fma32(y_step, oh - 1, y_base))
        lo_x = torch.floor(x_base)
        hi_x = torch.floor(fma32(x_step, ow - 1, x_base))
        if hl <= BAND_H - 8 and wl <= BAND_W - 128:  # the band holds it all
            fits = torch.ones_like(lo_y, dtype=torch.bool)
        else:
            fits = ((hi_y - lo_y + 9 <= BAND_H)
                    & (hi_x - lo_x + 129 <= BAND_W))
        lo_y_c = torch.clamp(lo_y, 0, hl - 1)
        lo_x_c = torch.clamp(lo_x, 0, wl - 1)
        y0 = torch.clamp(torch.floor(lo_y_c / 8) * 8, max=hp - BAND_H).to(i32)
        x0 = torch.clamp(torch.floor(lo_x_c / 128) * 128, max=wp - BAND_W).to(i32)
        scal = torch.stack(
            [y_base, y_step, x_base, x_step,
             torch.full_like(y_base, hl), torch.full_like(y_base, wl)], -1
        )
        ints = torch.stack([y0, x0, torch.full_like(y0, lvl)], -1)
        if sel_scal is None:
            sel_scal, sel_ints, done = scal, ints, fits
        else:
            take = (fits & ~done)[..., None]
            sel_scal = torch.where(take, scal, sel_scal)
            sel_ints = torch.where(take, ints, sel_ints)
            done = done | fits
    # the last level fits any box by construction (pyramid_dims)
    return sel_scal, sel_ints


def _rel_taps(base, step, n_out: int, span: int, src_len, off, dtype):
    """(M, n_out, span) two-tap interpolation matrices with indicators at
    clip(floor(pos), 0, src-1) - off and the +1 tap (JAX ``_rel_taps``)."""
    r = torch.arange(n_out, dtype=torch.float32, device=base.device)
    pos = fma32(r, step[:, None], base[:, None])
    lo = torch.floor(pos)
    w = torch.clamp(pos - lo, 0.0, 1.0)
    lim = src_len[:, None] - 1.0
    lo0 = torch.minimum(torch.clamp(lo, min=0.0), lim) - off[:, None]
    lo1 = torch.minimum(torch.clamp(lo + 1.0, min=0.0), lim) - off[:, None]
    grid = torch.arange(span, dtype=torch.float32, device=base.device)
    m = (grid == lo0[..., None]) * (1.0 - w[..., None]) + (
        grid == lo1[..., None]
    ) * w[..., None]
    return m.to(dtype)


def crop_and_resize_pyramid(
    image: torch.Tensor,  # (C, H, W) float
    boxes: torch.Tensor,  # (M, 4) xyxy in image pixels
    out_hw: tuple[int, int] = (128, 64),
) -> torch.Tensor:
    """The JAX package's dense stacked-einsum form of the banded crop
    (its CPU path and the Pallas kernel's oracle): (M, C, oh, ow) f32.
    A test oracle only; the pipeline crops with K4."""
    dt = image.dtype
    c, h, w = image.shape
    oh, ow = out_hw
    dims = pyramid_dims(h, w)
    pads = _pad_dims(dims)
    levels = build_pyramid(image)
    max_w = max(wp for _, wp in pads)
    stacked = torch.cat(
        [torch.nn.functional.pad(lv, (0, max_w - pw, 0, hp - ph))
         for lv, (ph, pw), (hp, _) in zip(levels, dims, pads)],
        dim=1,
    )  # (C, sum Hp, maxW)
    scal, ints = banded_prep(boxes, (h, w), dims, out_hw)
    row_off = torch.tensor(np.cumsum([0] + [hp for hp, _ in pads[:-1]]),
                           dtype=torch.float32, device=image.device)
    y_off = -row_off[ints[:, 2].long()]
    row_w = _rel_taps(scal[:, 0], scal[:, 1], oh, stacked.shape[1],
                      scal[:, 4], y_off, dt)
    col_w = _rel_taps(scal[:, 2], scal[:, 3], ow, stacked.shape[2],
                      scal[:, 5], torch.zeros_like(scal[:, 5]), dt)
    # columns first, intermediate in the compute dtype, f32 sums
    tmp = torch.einsum("mow,chw->mcho", col_w.float(), stacked.float()).to(dt)
    out = torch.einsum("mrh,mcho->mcro", row_w.float(), tmp.float())
    return out.to(dt).float()
