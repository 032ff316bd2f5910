"""K5: the pyramidal Lucas-Kanade kernel (``csrc/lk_pyramid.cu``), its
wrapper :func:`lk_pyramid`, and its plain PyTorch version
:func:`lk_pyramid_plain`.

Replaces ``strongsort_yolo_tpu/ops/pallas/lk_kernel.py``:
``lk_pyramid_pallas`` (all levels coarse to fine in one call) and
``lk_level_pallas`` (one level, :func:`lk_level_plain` here). Both follow
that kernel's ``_refine_level``, not the XLA path of ``gmc_tpu``: per
Gauss-Newton iteration the current plane is translated by the integer
part of the translation and blended bilinearly with its fraction, the
gradients are centred differences of the blended taps times ``0.5 * s``,
the validity mask is ``[1, w - 2.001]`` on the shifted coordinate, the
residual carries the linear part linearised, pixels with ``|e|`` at or
above ``max(3 * mean |e|, 40)`` are trimmed, and the 6x6 normal
equations (21 + 6 sums) get Levenberg damping ``1e-4 * trace / 6 + 1e-6``
and an unrolled Cholesky solve with a ``1e-20`` floor.

Params are six float32 values per pair, ``(a11, a12, tx, a21, a22, ty)``,
centred and normalised by the level's ``w / 2`` and so the same at every
level. Levels are given finest first, one to three of them;
``iters_by_level[l]`` is the iteration count of level ``l``, and the
levels are walked coarsest first. A level samples translations up to
``MAX_SHIFT`` level pixels.

The trimming threshold is a step: a sum taken in another order can move
a pixel across it. The kernel, this plain version and the TPU kernel
therefore agree to a tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from strongsort_yolo_tpu_torch.ops.cuda import _build

MAX_LEVELS = 3  # levels the kernel takes in one launch (kMaxLevels)
MAX_SHIFT = 32.0  # largest translation a level samples, level px (kMaxShift)
CLUSTER = 7  # thread blocks per pair, block r a band of each level (kCluster)
THREADS = 256  # threads per block (kThreads)


def _solve6(h_mat, g_vec, damp):
    """Unrolled 6x6 Cholesky solve of ``(H + damp I) x = g`` on (N,)
    tensors, in the TPU kernel's order of operations."""
    a = [[h_mat[i][j] + damp if i == j else h_mat[i][j] for j in range(6)]
         for i in range(6)]
    low = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            if i == j:
                low[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                low[i][j] = s / low[j][j]
    y = [None] * 6
    for i in range(6):
        s = g_vec[i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return x


def _sum_hw(x: torch.Tensor) -> torch.Tensor:
    return x.sum((1, 2))


def _refine_level(prev, cur, p, iters: int, total=_sum_hw) -> torch.Tensor:
    """``iters`` Gauss-Newton steps on one level: prev, cur (N, h, w)
    float32; p (N, 6) -> (N, 6). ``total`` sums an (N, h, w) tensor over
    the level, (N, h, w) -> (N,) (an emulation of the kernel's order of
    the sums passes its own)."""
    n, h, w = prev.shape
    dev, f32 = prev.device, torch.float32

    def const(v):  # a tensor operand: CUDA divides by a Python scalar
        # through its reciprocal
        return torch.tensor(v, dtype=f32, device=dev)

    s = const(w / 2.0)
    cx, cy = const((w - 1) / 2.0), const((h - 1) / 2.0)
    ix = torch.arange(w, dtype=f32, device=dev)
    iy = torch.arange(h, dtype=f32, device=dev)
    gxn = ((ix - cx) / s)[None, :].expand(h, w)
    gyn = ((iy - cy) / s)[:, None].expand(h, w)
    half_s = 0.5 * s
    hi_x, hi_y = const(w - 2.001), const(h - 2.001)
    # the window of rows/columns -1 .. h+1 (w+1) around the shift; indices
    # that leave the plane are clamped (only masked pixels read them)
    win_r = torch.arange(-1, h + 2, device=dev)
    win_c = torch.arange(-1, w + 2, device=dev)
    flat = cur.reshape(n, h * w)
    six = const(6.0)
    for _ in range(iters):
        a11, a12, tx, a21, a22, ty = p.unbind(1)
        txp = torch.clamp(s * tx, -MAX_SHIFT, MAX_SHIFT)
        typ = torch.clamp(s * ty, -MAX_SHIFT, MAX_SHIFT)
        kx, ky = torch.floor(txp), torch.floor(typ)
        fx = (txp - kx)[:, None, None]
        fy = (typ - ky)[:, None, None]
        rows = (win_r[None] + ky.long()[:, None]).clamp(0, h - 1)
        cols = (win_c[None] + kx.long()[:, None]).clamp(0, w - 1)
        idx = rows[:, :, None] * w + cols[:, None, :]
        win = torch.gather(flat, 1, idx.reshape(n, -1)).reshape(n, h + 3, w + 3)

        def tap(dy, dx):  # cur[i + ky + dy, j + kx + dx]
            return win[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

        def blend(dy, dx):
            return (
                (1 - fy) * ((1 - fx) * tap(dy, dx) + fx * tap(dy, dx + 1))
                + fy * ((1 - fx) * tap(dy + 1, dx) + fx * tap(dy + 1, dx + 1))
            )

        ct = blend(0, 0)
        ixw = (blend(0, 1) - blend(0, -1)) * half_s
        iyw = (blend(1, 0) - blend(-1, 0)) * half_s
        sx = ix[None, None, :] + txp[:, None, None]
        sy = iy[None, :, None] + typ[:, None, None]
        valid = ((sx >= 1.0) & (sx <= hi_x) & (sy >= 1.0) & (sy <= hi_y)).to(f32)
        e = (
            ct - prev
            + ((a11 - 1.0)[:, None, None] * gxn + a12[:, None, None] * gyn) * ixw
            + (a21[:, None, None] * gxn + (a22 - 1.0)[:, None, None] * gyn) * iyw
        )
        n_valid = total(valid) + 1.0
        thr = torch.clamp(3.0 * total(e.abs() * valid) / n_valid, min=40.0)
        wgt = torch.where(e.abs() < thr[:, None, None], valid, 0.0)
        js = (gxn * ixw, gyn * ixw, ixw, gxn * iyw, gyn * iyw, iyw)
        h_mat = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for k in range(i + 1):
                h_mat[i][k] = h_mat[k][i] = total(js[i] * js[k] * wgt)
        ew = e * wgt
        g_vec = [total(js[i] * ew) for i in range(6)]
        trace = (h_mat[0][0] + h_mat[1][1] + h_mat[2][2]
                 + h_mat[3][3] + h_mat[4][4] + h_mat[5][5])
        damp = 1e-4 * trace / six + 1e-6
        p = p - torch.stack(_solve6(h_mat, g_vec, damp), 1)
    return p


def lk_pyramid_plain(
    prev_levels,  # sequence of (N, h_l, w_l) float32 planes, finest first
    cur_levels,
    params: torch.Tensor,  # (N, 6) float32 normalised affine
    iters_by_level,  # iterations per level, finest first
) -> torch.Tensor:
    """All levels coarse to fine for N pairs -> (N, 6) float32."""
    if len(iters_by_level) != len(prev_levels):
        raise ValueError("lk_pyramid_plain wants one iteration count per level")
    p = params.float()
    for lvl in range(len(prev_levels) - 1, -1, -1):
        p = _refine_level(prev_levels[lvl].float(), cur_levels[lvl].float(),
                          p, int(iters_by_level[lvl]))
    return p


def lk_level_plain(prev, cur, params, iters: int):
    """One level (the form of ``lk_level_pallas``): (N, h, w) planes ->
    (N, 6)."""
    return lk_pyramid_plain((prev,), (cur,), params, (iters,))


def lk_pyramid(
    prev_levels,
    cur_levels,
    params: torch.Tensor,
    iters_by_level,
) -> torch.Tensor:
    """N (prev, cur) pyramids -> refined (N, 6) float32 params. CPU
    tensors take :func:`lk_pyramid_plain`; CUDA tensors launch K5, a
    cluster of thread blocks per pair, each block a fixed band of rows of
    every level. K5 reads the level planes where they lie (nothing is
    packed or copied): each plane must have unit column stride, while its
    rows and pairs may be strided (a view into a wider buffer); a plane
    with another column stride raises ValueError, as does a level whose
    band of rows does not fit a block's shared memory (a finest level of
    up to about 130k pixels fits)."""
    dev = params.device
    if dev.type == "cpu":
        return lk_pyramid_plain(prev_levels, cur_levels, params,
                                iters_by_level)
    if dev.type != "cuda":
        raise ValueError(f"lk_pyramid: unsupported device {dev}")
    n_levels = len(prev_levels)
    n = params.shape[0] if params.dim() == 2 else -1
    planes = list(prev_levels) + list(cur_levels)
    if (not 1 <= n_levels <= MAX_LEVELS or len(cur_levels) != n_levels
            or len(iters_by_level) != n_levels
            or params.shape != (n, 6) or params.dtype != torch.float32
            or any(x.dim() != 3 or x.shape[0] != n or x.dtype != torch.float32
                   or x.device != dev or min(x.shape[1:]) < 1 for x in planes)
            or any(a.shape != b.shape for a, b in zip(prev_levels, cur_levels))):
        raise ValueError(
            f"lk_pyramid wants 1 to {MAX_LEVELS} pairs of (N, h, w) float32 "
            "level planes, one iteration count per level and (N, 6) float32 "
            "params on one device"
        )
    if any(x.shape[2] > 1 and x.stride(2) != 1 for x in planes):
        raise ValueError("lk_pyramid wants level planes with unit column "
                         "stride (x.stride(2) == 1)")
    lib = _build.lib()
    dims = []
    for x, it in zip(prev_levels, iters_by_level):
        dims += [x.shape[1], x.shape[2], int(it)]
    dims_c = (ctypes.c_int * len(dims))(*dims)
    smem = lib.ssyt_lk_pyramid_smem_bytes(n_levels, dims_c)
    if not 0 < smem <= _build.MAX_SMEM:
        raise ValueError(
            f"lk_pyramid: levels {[tuple(x.shape[1:]) for x in prev_levels]} "
            f"need {smem} bytes of shared memory per block, over "
            f"{_build.MAX_SMEM}"
        )
    out = torch.empty((n, 6), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    params = params.contiguous()
    prev_c = (ctypes.c_void_p * n_levels)(*(x.data_ptr() for x in prev_levels))
    cur_c = (ctypes.c_void_p * n_levels)(*(x.data_ptr() for x in cur_levels))
    strides = []
    for a, b in zip(prev_levels, cur_levels):
        strides += [a.stride(0), a.stride(1), b.stride(0), b.stride(1)]
    strides_c = (ctypes.c_longlong * len(strides))(*strides)
    err = lib.ssyt_lk_pyramid(
        prev_c, cur_c, strides_c, params.data_ptr(), out.data_ptr(), n,
        n_levels, dims_c, torch.cuda.current_stream(dev).cuda_stream,
    )
    lk_pyramid.launches += 1
    _build.check(err, "lk_pyramid")
    return out


lk_pyramid.launches = 0
