"""ReID crops of the reference: each box is sampled bilinearly (half-pixel
centres, edges clamped) into a 128 x 64 crop from one level of the
frame's pyramid. Level 0 is the frame at half size; each further level a
2x bilinear decimation of the one before, until a level fits a 248 x 384
window. A box takes the finest level on which its samples span at most
248 - 1 rows and 384 - 1 columns (with the 8- and 128-pixel alignment
of the window's origin: rows ``hi - lo + 9 <= 256``, columns ``hi - lo +
129 <= 512``), or any level that fits the window whole."""

from __future__ import annotations

import torch
import torch.nn.functional as F

WIN_H, WIN_W = 256, 512


def _resize_axis(x: torch.Tensor, dim: int, n: int, dtype) -> torch.Tensor:
    """Bilinear resize (half-pixel centres) of one axis, summed in float32
    and rounded to ``dtype``."""
    size = list(x.shape[-2:])
    size[dim] = n
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False).to(dtype)


def pyramid(frames: torch.Tensor, dtype=torch.float32) -> list[torch.Tensor]:
    """(S, H, W, 3) uint8 -> levels (S, 3, h_l, w_l) in [0, 1]: the frame
    divided by 255 at ``dtype``, each level the one before resized rows
    then columns, each pass rounded to ``dtype``."""
    x = frames.permute(0, 3, 1, 2).to(dtype) / torch.full((), 255.0, dtype=dtype,
                                                           device=frames.device)
    h, w = x.shape[-2:]
    dims = [(max(h // 2, 1), max(w // 2, 1))]
    while dims[-1][0] > WIN_H - 8 or dims[-1][1] > WIN_W - 128:
        dims.append((max(dims[-1][0] // 2, 1), max(dims[-1][1] // 2, 1)))
    levels = []
    for dh, dw in dims:
        x = _resize_axis(_resize_axis(x, 0, dh, dtype), 1, dw, dtype)
        levels.append(x)
    return levels


def _axis(lo_edge, size, scale, n_out, src_len):
    """Sample positions of one axis: (M, n_out) float32."""
    step = size * scale / n_out
    base = (lo_edge + 0.5 * size / n_out) * scale - 0.5
    r = torch.arange(n_out, device=lo_edge.device, dtype=torch.float32)
    return base[:, None] + r[None] * step[:, None]


def crops(levels, frame_hw, frame_of: torch.Tensor, boxes: torch.Tensor,
          out_hw=(128, 64)) -> torch.Tensor:
    """boxes (M, 4) xyxy frame pixels of frames ``frame_of`` (M,) ->
    (M, 3, oh, ow) float32 crops."""
    H, W = frame_hw
    oh, ow = out_hw
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    sy_, sx_ = torch.clamp(y2 - y1, min=1e-3), torch.clamp(x2 - x1, min=1e-3)
    chosen = torch.full_like(x1, -1, dtype=torch.long)
    for lvl, lv in enumerate(levels):
        hl, wl = lv.shape[-2:]
        py = _axis(y1, sy_, hl / H, oh, hl)
        px = _axis(x1, sx_, wl / W, ow, wl)
        whole = hl <= WIN_H - 8 and wl <= WIN_W - 128
        fits = torch.ones_like(x1, dtype=torch.bool) if whole else (
            (py[:, -1].floor() - py[:, 0].floor() + 9 <= WIN_H)
            & (px[:, -1].floor() - px[:, 0].floor() + 129 <= WIN_W))
        chosen = torch.where((chosen < 0) & fits, lvl, chosen)
    out = torch.empty((len(boxes), 3, oh, ow), device=boxes.device)  # float32
    for lvl, lv in enumerate(levels):
        sel = torch.nonzero(chosen == lvl).flatten()
        if len(sel) == 0:
            continue
        hl, wl = lv.shape[-2:]
        py = _axis(y1[sel], sy_[sel], hl / H, oh, hl)
        px = _axis(x1[sel], sx_[sel], wl / W, ow, wl)
        ylo = torch.floor(py)
        xlo = torch.floor(px)
        wy = torch.clamp(py - ylo, 0, 1)[:, None, :, None]
        wx = torch.clamp(px - xlo, 0, 1)[:, None, None, :]
        y0 = ylo.clamp(0, hl - 1).long()
        y1i = (ylo + 1).clamp(0, hl - 1).long()
        x0 = xlo.clamp(0, wl - 1).long()
        x1i = (xlo + 1).clamp(0, wl - 1).long()
        f = frame_of[sel][:, None, None]

        def at(yy, xx):  # (m, 3, oh, ow) samples of the level
            return lv[f, :, yy[:, :, None], xx[:, None, :]].permute(0, 3, 1, 2)

        dt = lv.dtype  # columns first, each pass rounded to the levels' dtype
        top = ((1 - wx) * at(y0, x0).float() + wx * at(y0, x1i).float()).to(dt)
        bot = ((1 - wx) * at(y1i, x0).float() + wx * at(y1i, x1i).float()).to(dt)
        out[sel] = ((1 - wy) * top.float() + wy * bot.float()).to(dt).float()
    return out
