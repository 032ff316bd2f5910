"""K4: the banded pyramid crop kernel (``csrc/banded_crop.cu``), its
wrapper, and its plain PyTorch version :func:`banded_crop_plain`.

Replaces ``strongsort_yolo_tpu/ops/pallas/crop_kernel.py``:
``banded_crop_planar`` (the fixed-width form, ``slot_frame = arange(G) //
M``, see :func:`banded_crop_frames`) and ``banded_crop_packed`` (any
``slot_frame``). Both follow the TPU kernel's ``_tap_and_sample``: per
slot, output row r samples ``clip(y_base + r * y_step, 0, h_l - 1)`` of
its pyramid level (the multiply-add rounded once, as the JAX reference
computes it) with weights ``max(0, 1 - |i - pos|)`` cast to the compute
dtype; columns first, the column sums rounded to the compute dtype, then
the rows, rounded again.
"""

from __future__ import annotations

import torch

from strongsort_yolo_tpu_torch.ops.crops import (
    PyramidStack,
    banded_prep,
    fma32,
    pyramid_stack,
)
from strongsort_yolo_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _axis_taps(base, step, n: int, length, dt):
    """(G, n) tap indices lo/hi inside [0, length - 1] and their weights
    rounded to ``dt`` (held in float32)."""
    f32 = torch.float32
    k = torch.arange(n, dtype=f32, device=base.device)
    pos = fma32(k, step[:, None], base[:, None])
    pos = torch.minimum(torch.clamp(pos, min=0.0), (length - 1.0)[:, None])
    lo = torch.floor(pos)
    w_lo = torch.clamp(1.0 - (lo - pos).abs(), min=0.0).to(dt).to(f32)
    w_hi = torch.clamp(1.0 - (lo + 1.0 - pos).abs(), min=0.0).to(dt).to(f32)
    # the hi tap at index `length` carries weight 0: read length - 1
    hi = torch.minimum(lo + 1.0, (length - 1.0)[:, None])
    return lo.long(), hi.long(), w_lo, w_hi


def banded_crop_plain(
    pyr: PyramidStack,
    scal: torch.Tensor,  # (G, 6) f32, banded_prep rows
    ints: torch.Tensor,  # (G, 3) i32, banded_prep rows
    slot_frame: torch.Tensor,  # (G,) i32 source frame of each slot
    out_hw: tuple[int, int] = (128, 64),
) -> torch.Tensor:
    """-> (G, C, oh, ow) crops in the pyramid's dtype."""
    stack = pyr.stack
    s, c, sum_h, width = stack.shape
    dt, f32 = stack.dtype, torch.float32
    oh, ow = out_hw
    lvl = ints[:, 2].long().clamp(0, len(pyr.dims) - 1)
    frame = slot_frame.long().clamp(0, s - 1)
    y_lo, y_hi, wy0, wy1 = _axis_taps(scal[:, 0], scal[:, 1], oh, scal[:, 4], dt)
    x_lo, x_hi, wx0, wx1 = _axis_taps(scal[:, 2], scal[:, 3], ow, scal[:, 5], dt)
    off = pyr.row_off.long()[lvl][:, None]
    chan = torch.arange(c, device=stack.device)
    base = (frame[:, None] * c + chan) * sum_h  # (G, C)
    flat = stack.reshape(-1)

    def read(rows, cols):  # (G, oh), (G, ow) -> (G, C, oh, ow) f32
        line = (base[:, :, None] + off[:, None] + rows[:, None, :]) * width
        return flat[line[..., None] + cols[:, None, None, :]].to(f32)

    wx0, wx1 = wx0[:, None, None, :], wx1[:, None, None, :]
    t0 = (wx0 * read(y_lo, x_lo) + wx1 * read(y_lo, x_hi)).to(dt).to(f32)
    t1 = (wx0 * read(y_hi, x_lo) + wx1 * read(y_hi, x_hi)).to(dt).to(f32)
    return (wy0[:, None, :, None] * t0 + wy1[:, None, :, None] * t1).to(dt)


def banded_crop(
    pyr: PyramidStack,
    scal: torch.Tensor,
    ints: torch.Tensor,
    slot_frame: torch.Tensor,
    out_hw: tuple[int, int] = (128, 64),
) -> torch.Tensor:
    """G crop slots sampled from the pyramid of S frames -> (G, 3, oh, ow)
    in the pyramid's dtype. CPU tensors take :func:`banded_crop_plain`;
    CUDA tensors launch K4, one block per slot and tile of 16 output rows
    and 64 columns."""
    stack = pyr.stack
    if stack.device.type == "cpu":
        return banded_crop_plain(pyr, scal, ints, slot_frame, out_hw)
    if stack.device.type != "cuda":
        raise ValueError(f"banded_crop: unsupported device {stack.device}")
    dev = stack.device
    g = scal.shape[0]
    if (stack.dim() != 4 or stack.shape[1] != 3 or stack.dtype not in _DTYPES
            or scal.shape != (g, 6) or scal.dtype != torch.float32
            or ints.shape != (g, 3) or ints.dtype != torch.int32
            or slot_frame.shape != (g,) or slot_frame.dtype != torch.int32
            or pyr.row_off.dtype != torch.int32
            or pyr.row_off.shape != (len(pyr.dims),)
            or any(x.device != dev
                   for x in (scal, ints, slot_frame, pyr.row_off))):
        raise ValueError(
            "banded_crop wants a (S, 3, H, W) f32/bf16 stack, scal (G, 6) "
            "f32, ints (G, 3) i32, slot_frame (G,) i32 and (L,) i32 row "
            "offsets on one device"
        )
    oh, ow = out_hw
    s, _, sum_h, width = stack.shape
    stack = stack.contiguous()
    scal, ints = scal.contiguous(), ints.contiguous()
    slot_frame, row_off = slot_frame.contiguous(), pyr.row_off.contiguous()
    out = torch.empty((g, 3, oh, ow), dtype=stack.dtype, device=dev)
    err = _build.lib().ssyt_banded_crop(
        stack.data_ptr(), _DTYPES[stack.dtype], row_off.data_ptr(),
        len(pyr.dims), scal.data_ptr(), ints.data_ptr(),
        slot_frame.data_ptr(), out.data_ptr(), s, sum_h, width, g, oh, ow,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    banded_crop.launches += 1
    _build.check(err, "banded_crop")
    return out


banded_crop.launches = 0


def banded_crop_frames(
    frames: torch.Tensor,  # (B, 3, H, W) float in [0, 1], compute dtype
    boxes: torch.Tensor,  # (B, M, 4) xyxy in source pixels
    out_hw: tuple[int, int] = (128, 64),
) -> torch.Tensor:
    """The fixed-width form: M crops of each of B frames -> (B, M, 3, oh,
    ow), slot b*M + i cut from frame b."""
    b, m = boxes.shape[:2]
    pyr = pyramid_stack(frames)
    scal, ints = banded_prep(boxes.reshape(b * m, 4), pyr.src_hw, pyr.dims,
                             out_hw)
    slot_frame = torch.div(
        torch.arange(b * m, device=frames.device), m, rounding_mode="floor"
    ).to(torch.int32)
    out = banded_crop(pyr, scal, ints, slot_frame, out_hw)
    return out.reshape(b, m, *out.shape[1:])
