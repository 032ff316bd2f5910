"""Camera motion between consecutive frames by dense pyramidal
Lucas-Kanade, the semantics of the program's ``gmc_method="flow_tpu"``.

Each frame becomes a 180 x 320 gray image (BT.601 luma in bfloat16,
bilinear resize); two coarser levels are 2x2 means; every level is blurred by a
5-tap binomial with replicated edges. A centred affine, normalised by
the level's w / 2, is refined coarse to fine by 8, 5 and 2 Gauss-Newton
steps: the current plane is translated by the translation (bilinear
samples, up to 32 level pixels), the linear part enters linearised, the
gradients are centred differences times w / 4, pixels whose shifted
position leaves [1, size - 2.001] or whose residual is at or above
max(3 mean |e|, 40) do not count, and the normal equations get
Levenberg damping 1e-4 trace / 6 + 1e-6. The result maps previous-frame
coordinates to current-frame coordinates in frame pixels. ``dtype``
sets the precision of the levels and the solve: float32 as stated, the
control bfloat16."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BASE_H, BASE_W = 180, 320
ITERS = (8, 5, 2)  # coarsest level first
MAX_SHIFT = 32.0
LUMA_BGR = (0.114, 0.587, 0.299)
BLUR = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


def gray(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR -> (N, 180, 320) float32 gray, as the
    system defines it: the luma's three products and two sums each
    rounded to bfloat16 (its weights too), then the resize rows then
    columns, each pass summed in float32 and rounded to bfloat16."""
    bf = torch.bfloat16
    x = frames.to(bf)
    k = [torch.tensor(c, dtype=bf, device=frames.device) for c in LUMA_BGR]
    g = (k[0] * x[..., 0] + k[1] * x[..., 1] + k[2] * x[..., 2])[:, None]
    g = F.interpolate(g.float(), size=(BASE_H, g.shape[-1]), mode="bilinear",
                      align_corners=False).to(bf)
    g = F.interpolate(g.float(), size=(BASE_H, BASE_W), mode="bilinear",
                      align_corners=False).to(bf)
    return g[:, 0].float()


def _blur(img: torch.Tensor) -> torch.Tensor:
    k = torch.tensor(BLUR, dtype=img.dtype, device=img.device)
    x = F.pad(img[:, None], (2, 2, 2, 2), mode="replicate")
    x = F.conv2d(x.float(), k.float().view(1, 1, 1, 5)).to(img.dtype)
    return F.conv2d(x.float(), k.float().view(1, 1, 5, 1))[:, 0].to(img.dtype)


def levels(g: torch.Tensor) -> list[torch.Tensor]:
    """Blurred pyramid, finest first."""
    out = [g]
    for _ in range(2):
        out.append(F.avg_pool2d(out[-1][:, None].float(), 2)[:, 0].to(g.dtype))
    return [_blur(x) for x in out]


def _shifted(cur: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor):
    """cur sampled at (x + tx, y + ty), bilinear, edges clamped, and its
    centred differences."""
    n, h, w = cur.shape
    dt = cur.dtype
    kx, ky = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - kx)[:, None, None], (ty - ky)[:, None, None]
    cols = (torch.arange(-1, w + 2, device=cur.device)[None] + kx.long()[:, None]).clamp(0, w - 1)
    rows = (torch.arange(-1, h + 2, device=cur.device)[None] + ky.long()[:, None]).clamp(0, h - 1)
    win = cur[torch.arange(n, device=cur.device)[:, None, None],
              rows[:, :, None], cols[:, None, :]]

    def at(dy, dx):
        return win[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    def blend(dy, dx):
        return ((1 - fy) * ((1 - fx) * at(dy, dx) + fx * at(dy, dx + 1))
                + fy * ((1 - fx) * at(dy + 1, dx) + fx * at(dy + 1, dx + 1))).to(dt)

    return blend(0, 0), blend(0, 1) - blend(0, -1), blend(1, 0) - blend(-1, 0)


def _refine(prev, cur, p, iters: int):
    n, h, w = prev.shape
    dt, dev = prev.dtype, prev.device
    s = w / 2.0
    gx = ((torch.arange(w, device=dev, dtype=torch.float32) - (w - 1) / 2) / s).to(dt)
    gy = ((torch.arange(h, device=dev, dtype=torch.float32) - (h - 1) / 2) / s).to(dt)
    gx, gy = gx[None, None, :].expand(1, h, w), gy[None, :, None].expand(1, h, w)
    for _ in range(iters):
        a11, a12, tx, a21, a22, ty = (v[:, None, None] for v in p.unbind(1))
        txp = torch.clamp(s * p[:, 2], -MAX_SHIFT, MAX_SHIFT)
        typ = torch.clamp(s * p[:, 5], -MAX_SHIFT, MAX_SHIFT)
        ct, dx, dy = _shifted(cur, txp, typ)
        ix, iy = dx * (0.5 * s), dy * (0.5 * s)
        sx = torch.arange(w, device=dev)[None, None, :] + txp[:, None, None]
        sy = torch.arange(h, device=dev)[None, :, None] + typ[:, None, None]
        valid = ((sx >= 1) & (sx <= w - 2.001) & (sy >= 1) & (sy <= h - 2.001)).to(dt)
        e = (ct - prev + ((a11 - 1) * gx + a12 * gy) * ix
             + (a21 * gx + (a22 - 1) * gy) * iy).to(dt)
        thr = torch.clamp(3 * (e.abs() * valid).sum((1, 2)) / (valid.sum((1, 2)) + 1),
                          min=40.0)
        wgt = torch.where(e.abs() < thr[:, None, None], valid, 0).to(dt)
        J = torch.stack([gx * ix, gy * ix, ix, gx * iy, gy * iy, iy], -1).to(dt)
        Jw = J * wgt[..., None]
        H = torch.einsum("nhwi,nhwj->nij", Jw, J).to(dt).float()
        g = torch.einsum("nhwi,nhw->ni", Jw, e).to(dt).float()
        damp = 1e-4 * H.diagonal(dim1=1, dim2=2).sum(-1) / 6 + 1e-6
        H = H + damp[:, None, None] * torch.eye(6, device=dev)
        p = (p.float() - torch.linalg.solve(H, g)).to(dt)
    return p


def warps(prev_frames: torch.Tensor, cur_frames: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) uint8 pairs -> (N, 2, 3) float32 warps prev -> cur."""
    n, H, W = cur_frames.shape[:3]
    pv = levels(gray(prev_frames).to(dtype))
    cv = levels(gray(cur_frames).to(dtype))
    p = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=cur_frames.device)
    p = p.to(dtype).repeat(n, 1)
    for lvl in range(len(pv) - 1, -1, -1):
        p = _refine(pv[lvl], cv[lvl], p, ITERS[len(pv) - 1 - lvl])
    a11, a12, tx, a21, a22, ty = p.float().unbind(1)
    s = BASE_W / 2.0
    cx, cy = (BASE_W - 1) / 2.0, (BASE_H - 1) / 2.0
    tpx = s * tx + cx - a11 * cx - a12 * cy
    tpy = s * ty + cy - a21 * cx - a22 * cy
    sx, sy = W / BASE_W, H / BASE_H
    return torch.stack([torch.stack([a11, a12 * sx / sy, tpx * sx], -1),
                        torch.stack([a21 * sy / sx, a22, tpy * sy], -1)], -2)
