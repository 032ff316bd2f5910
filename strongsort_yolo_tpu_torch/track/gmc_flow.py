"""Camera-motion compensation on the device: dense pyramidal Lucas-Kanade.

Counterpart of ``strongsort_yolo_tpu/track/gmc_tpu.py`` (nothing in it is
specific to a TPU, hence the name); the tracker option keeps its name,
``gmc_method="flow_tpu"``, so configs read the same in both packages.
Each frame becomes a 180x320 float32 gray image (BT.601 luma in bf16,
then a bilinear resize); two coarser levels come from exact 2x2 means,
every level is blurred with a 5-tap binomial, and K5
(``ops/cuda/lk_kernel.lk_pyramid``) refines a centred, width-normalised
affine coarse to fine (8, 5 and 2 Gauss-Newton steps). The result is the
(2, 3) warp that maps previous-frame coordinates to current-frame
coordinates, identity on a stream's first frame, as the host estimators
of ``track/gmc.py`` return it.

The resize and the pool are written as two taps per axis, each product
and two-tap sum taken in float32 and rounded to the image dtype once per
axis, which is what the JAX package's interpolation-matrix contractions
compute. Every function takes a batch of N images or pairs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import lk_pyramid
from strongsort_yolo_tpu_torch.ops.letterbox import _axis_taps

# base gray resolution; two coarser levels follow by 2x2 mean pooling
BASE_H, BASE_W = 180, 320
_LEVELS = 3
# Gauss-Newton steps per level, indexed finest first: the coarsest level
# does the motion search, the finer ones polish
_ITERS_BY_LEVEL = (2, 5, 8)
_LUMA_BGR = (0.114, 0.587, 0.299)  # cv2.COLOR_BGR2GRAY weights
_BLUR = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


@functools.lru_cache(maxsize=64)
def _taps(dst: int, src: int, device: torch.device, dtype: torch.dtype):
    """One axis's tap indices and weights (rounded to ``dtype``, held in
    float32) on ``device``, uploaded once per shape."""
    idx, wts = _axis_taps(dst, src)
    lo, hi = (torch.from_numpy(i.astype(np.int64)).to(device) for i in idx)
    w_lo, w_hi = (torch.from_numpy(w).to(device, dtype).float() for w in wts)
    return lo, hi, w_lo, w_hi


def _resize_axis(x: torch.Tensor, dim: int, dst: int) -> torch.Tensor:
    """Bilinear resize (half-pixel centres, edge-clamped) of one axis of
    ``x`` to ``dst`` samples: the two taps of each output weighted by the
    interpolation matrix's entries rounded to ``x.dtype``, summed in
    float32 and rounded to ``x.dtype``."""
    src = x.shape[dim]
    if dst == src:
        return x
    lo, hi, w_lo, w_hi = _taps(dst, src, x.device, x.dtype)
    shape = [1] * x.dim()
    shape[dim] = dst
    w_lo, w_hi = w_lo.reshape(shape), w_hi.reshape(shape)
    out = (w_lo * x.index_select(dim, lo).float()
           + w_hi * x.index_select(dim, hi).float())
    return out.to(x.dtype)


def _resize(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(..., H, W) -> (..., new_h, new_w), rows then columns."""
    return _resize_axis(_resize_axis(img, -2, new_h), -1, new_w)


def frame_to_gray(frame_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR uint8 -> (..., BASE_H, BASE_W) float32 gray.
    The luma's three products and two sums are each rounded to bf16 (u8
    values are exact there), then the resize runs in bf16."""
    x = frame_u8.to(torch.bfloat16)
    k = [torch.full((), c, dtype=torch.bfloat16, device=x.device)
         for c in _LUMA_BGR]
    gray = k[0] * x[..., 0] + k[1] * x[..., 1] + k[2] * x[..., 2]
    return _resize(gray, BASE_H, BASE_W).float()


def _pool2(img: torch.Tensor) -> torch.Tensor:
    """(..., h, w) -> (..., h // 2, w // 2) 2x2 mean: the half-size
    bilinear resize, whose taps are 0.5 and 0.5 at rows 2i and 2i + 1."""
    h, w = img.shape[-2:]
    return _resize(img, h // 2, w // 2)


def _blur(img: torch.Tensor) -> torch.Tensor:
    """(..., h, w) separable 5-tap binomial smoothing, edges replicated:
    the Lucas-Kanade prefilter (without it the linearised bilinear model
    underestimates motion on high-frequency content)."""
    h, w = img.shape[-2:]
    dev = img.device
    cols = torch.arange(-2, w + 2, device=dev).clamp(0, w - 1)
    px = img.index_select(-1, cols)
    out = sum(k * px[..., i:i + w] for i, k in enumerate(_BLUR))
    rows = torch.arange(-2, h + 2, device=dev).clamp(0, h - 1)
    py = out.index_select(-2, rows)
    return sum(k * py[..., i:i + h, :] for i, k in enumerate(_BLUR))


def pyramid(gray: torch.Tensor) -> list[torch.Tensor]:
    """(N, BASE_H, BASE_W) grays -> K5's input: the _LEVELS blurred
    levels, finest first."""
    levels = [gray.float()]
    for _ in range(_LEVELS - 1):
        levels.append(_pool2(levels[-1]))
    return [_blur(x) for x in levels]


def _identity(n: int, device) -> torch.Tensor:
    """(n, 2, 3) float32 identity warps, made on the device (no copy)."""
    return torch.eye(2, 3, dtype=torch.float32,
                     device=device).expand(n, 2, 3).contiguous()


def estimate_warp(
    prev_gray: torch.Tensor,
    cur_gray: torch.Tensor,
    *,
    scale_x: float = 1.0,
    scale_y: float = 1.0,
) -> torch.Tensor:
    """(N, BASE_H, BASE_W) gray pairs -> (N, 2, 3) warps prev -> cur in
    original frame coordinates (``scale_*`` = original / base pixel
    ratio). All N pairs take one K5 launch on the card."""
    n, dev = prev_gray.shape[0], prev_gray.device
    params = _identity(1, dev).reshape(1, 6).repeat(n, 1)
    params = lk_pyramid(pyramid(prev_gray), pyramid(cur_gray), params,
                        _ITERS_BY_LEVEL)
    a11, a12, tx, a21, a22, ty = params.unbind(1)
    # normalised -> base pixel coordinates
    s = BASE_W / 2.0
    cx, cy = (BASE_W - 1) / 2.0, (BASE_H - 1) / 2.0
    tpx = s * tx + cx - a11 * cx - a12 * cy
    tpy = s * ty + cy - a21 * cx - a22 * cy
    # conjugate by the base -> original scaling diag(sx, sy)
    sx = torch.full((), scale_x, dtype=torch.float32, device=dev)
    sy = torch.full((), scale_y, dtype=torch.float32, device=dev)
    return torch.stack([
        torch.stack([a11, a12 * sx / sy, tpx * sx], -1),
        torch.stack([a21 * sy / sx, a22, tpy * sy], -1),
    ], -2)


def batched_warps(
    prev_grays: torch.Tensor,
    cur_grays: torch.Tensor,
    src_hw: tuple[int, int],
    has_prev: torch.Tensor,
) -> torch.Tensor:
    """(S, BASE_H, BASE_W) grays of S streams (or T consecutive frames) ->
    (S, 2, 3) warps, one K5 launch for all S; the identity where
    ``has_prev`` (S,) bool is False. The estimate runs for every pair and
    ``torch.where`` selects, so a pair without a previous frame never
    leaks a non-finite value."""
    src_h, src_w = src_hw
    est = estimate_warp(prev_grays, cur_grays, scale_x=src_w / BASE_W,
                        scale_y=src_h / BASE_H)
    ident = _identity(cur_grays.shape[0], cur_grays.device)
    return torch.where(has_prev[:, None, None], est, ident)


class FlowGMC:
    """One stream's camera-motion state: its previous gray frame, kept on
    the device (``prev``, None before the first frame). ``warps`` takes T
    consecutive frames and estimates all T pairs (previous gray, gray) in
    one K5 launch, the first frame of the stream getting the identity;
    ``reset``/``apply`` is the per-frame protocol of ``track/gmc.py``
    (numpy in, (2, 3) numpy out)."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.prev: torch.Tensor | None = None  # (BASE_H, BASE_W) float32

    def reset(self) -> None:
        self.prev = None

    def warps(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(T, H, W, 3) uint8 BGR on the device -> (T, 2, 3) warps."""
        grays = frame_to_gray(frames_u8)
        t = grays.shape[0]
        first = 0 if self.prev is not None else 1
        prev = self.prev if first == 0 else torch.zeros_like(grays[0])
        has_prev = torch.arange(t, device=grays.device) >= first
        warps = batched_warps(torch.cat([prev[None], grays[:-1]]), grays,
                              frames_u8.shape[1:3], has_prev)
        self.prev = grays[-1]
        return warps

    def apply(self, frame_bgr: np.ndarray) -> np.ndarray:
        frame = torch.from_numpy(np.ascontiguousarray(frame_bgr))
        return self.warps(frame[None].to(self.device))[0].cpu().numpy()
