"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)
and the operations and bytes the measured kernels must do, from their
shapes. Each input byte is counted once and each output byte once."""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
SECTOR = 32  # bytes: the least the card's memory moves at once


def bound_s(nbytes: float, ops: float, kind: str = "f32") -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def weighed(dst: int, src: int) -> np.ndarray:
    """Source indices that a bilinear (half-pixel, edge-clamped) resize
    src -> dst weighs above zero."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos)
    w_hi = np.clip(pos - lo, 0.0, 1.0)
    lo_c = np.clip(lo, 0, src - 1).astype(int)
    hi_c = np.clip(lo + 1, 0, src - 1).astype(int)
    return np.unique(np.concatenate([lo_c[w_hi < 1.0], hi_c[w_hi > 0.0]]))


def letterbox_dims(h: int, w: int, size: int) -> tuple[int, int]:
    gain = min(size / h, size / w)
    return int(round(h * gain)), int(round(w * gain))


def k1_bytes(s: int, h: int, w: int, size: int, out_bytes: int = 2) -> int:
    """K1 (letterbox of S (h, w, 3) uint8 frames into (S, 3, size, size)):
    the 32-byte sectors of each frame that hold a weighed pixel, the two
    tap tables (int32 index and float32 weight, two taps per output row
    and column) and the output."""
    nh, nw = letterbox_dims(h, w, size)
    rows, cols = weighed(nh, h), weighed(nw, w)
    touched = np.zeros(w * 3, bool)
    for c in range(3):
        touched[cols * 3 + c] = True
    sectors = int(touched.reshape(-1, SECTOR).any(-1).sum()) if (
        w * 3 % SECTOR == 0) else int(np.ceil(w * 3 / SECTOR))
    return (s * len(rows) * sectors * SECTOR + 2 * 2 * (nh + nw) * 4
            + s * 3 * size * size * out_bytes)


# K2 (greedy NMS keep mask of K score-sorted candidates a frame): about 15
# float32 operations per pair j < i (two max, two min, two differences,
# two clamps, the product, the area sum and difference, the division and
# the comparison) over (K, 4) boxes and (K,) scores read and (K,) flags
# written
NMS_OPS_PER_PAIR = 15


def k2_work(s: int, k: int = 512) -> tuple[int, float]:
    """-> (bytes, operations) of one K2 launch over S frames."""
    return s * k * (16 + 4 + 1), s * NMS_OPS_PER_PAIR * k * (k - 1) / 2


def k3_bytes(p: int, r: int, c: int) -> int:
    """K3 (auction over P (R, C) cost matrices): each float32 cost read
    once, the row and column masks and thresholds read, the row and
    column assignments (int32) written."""
    return p * (r * c * 4 + (r + c) * 1 + 4 + (r + c) * 4)


# K5: about 90 operations per pixel and Gauss-Newton step (the blend of
# four taps and its two centred differences, the residual with the
# linearised affine, the trimming, and the 21 + 6 weighed products of
# the normal equations), as the program's kernel notes count them
LK_OPS_PER_PIXEL_STEP = 90
LK_LEVELS = ((180, 320, 2), (90, 160, 5), (45, 80, 8))  # h, w, steps


def k5_work(pairs: int) -> tuple[int, float]:
    """-> (bytes, operations) of one K5 launch over N frame pairs: each
    float32 level plane of both frames read once, (N, 6) params in and
    out."""
    pixels = sum(h * w for h, w, _ in LK_LEVELS)
    steps = sum(h * w * n for h, w, n in LK_LEVELS)
    return pairs * (2 * pixels * 4 + 2 * 6 * 4), pairs * steps * LK_OPS_PER_PIXEL_STEP
