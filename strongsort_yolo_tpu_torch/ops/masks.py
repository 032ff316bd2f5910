"""Instance masks on the device and their polygons on the host.

Counterpart of ``strongsort_yolo_tpu/ops/masks.py``:

- :func:`process_masks`: mask = sigmoid(coef . proto) cropped to the
  detection box, one (M, nm) @ (nm, Hm * Wm) product per frame in full
  float32 (TF32 off: the JAX package computes it at
  ``Precision.HIGHEST``);
- :func:`masks_to_polygons`: the largest outer contour of each
  thresholded mask, mapped to frame coordinates: the ``.masks.xy``
  surface. The JAX package calls ``cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)`` and keeps the contour of largest
  ``cv2.contourArea``; the machine with the card has no cv2, so
  :func:`outer_contours` follows the borders itself, with OpenCV's
  algorithm (Suzuki-Abe border following, as in OpenCV's
  ``icvFetchContour``, on a zero-padded copy): the same vertices, start
  point, orientation and order of contours.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _full_float32():
    """Float32 matrix products without TF32 on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def process_masks(
    coefs: torch.Tensor,  # (..., M, nm) mask coefficients of kept detections
    proto: torch.Tensor,  # (..., nm, Hm, Wm) prototypes, channels first
    boxes: torch.Tensor,  # (..., M, 4) xyxy in model-input pixels
    input_hw: tuple[int, int],
) -> torch.Tensor:
    """-> (..., M, Hm, Wm) float32 masks in [0, 1], zero outside each box
    (a pixel is inside where its centre lies in [x1, x2) x [y1, y2) on the
    prototype grid, input / 4). ``proto`` is the model's channels-first
    output; the JAX function takes it channels last."""
    hm, wm = proto.shape[-2:]
    with _full_float32():
        logits = torch.matmul(coefs.float(), proto.float().flatten(-2))
    masks = torch.sigmoid(logits).reshape(*logits.shape[:-1], hm, wm)
    sx = wm / input_hw[1]
    sy = hm / input_hw[0]
    dev = masks.device
    x = torch.arange(wm, dtype=torch.float32, device=dev) + 0.5
    y = (torch.arange(hm, dtype=torch.float32, device=dev) + 0.5)[:, None]
    b = boxes.float()[..., None, None]  # (..., M, 4, 1, 1)
    inside = ((x >= b[..., 0, :, :] * sx) & (x < b[..., 2, :, :] * sx)
              & (y >= b[..., 1, :, :] * sy) & (y < b[..., 3, :, :] * sy))
    return torch.where(inside, masks, 0.0)


# chain codes: 0 right, 1 up-right, 2 up, 3 up-left, 4 left, 5 down-left,
# 6 down, 7 down-right (image rows grow downwards)
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BOUND = -126  # OpenCV's mark of a border pixel left to the right
_VISITED = 2  # its mark of any other followed border pixel


def _follow(img: list, step: int, i0: int, x: int, y: int) -> list:
    """Follow the outer border that starts at flat index ``i0`` (pixel
    (x, y)) of the padded label image ``img`` (a flat list, 0 background,
    1 unvisited foreground), marking its pixels as OpenCV does, and return
    its CHAIN_APPROX_SIMPLE vertices: the pixels where the chain code
    changes, counter-clockwise on screen from the start."""
    deltas = (1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1) * 2
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        img[i0] = _RIGHT_BOUND
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            img[i3] = _RIGHT_BOUND
        elif img[i3] == 1:
            img[i3] = _VISITED
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _CODE_DX[s]
        y += _CODE_DY[s]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def _shoelace(pts: list) -> float:
    """|area| of the closed polygon through ``pts``, as cv2.contourArea."""
    acc, (px, py) = 0, pts[-1]
    for x, y in pts:
        acc += px * y - py * x
        px, py = x, y
    return abs(acc) / 2.0


def _outer_borders(binary: np.ndarray) -> list[tuple[list, float]]:
    """(vertices, area) of each outer contour of :func:`outer_contours`,
    in the order found; vertices in the coordinates of ``binary``."""
    m = np.asarray(binary) != 0
    if not m.any():
        return []
    rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
    y0, x0 = int(rows[0]), int(cols[0])
    crop = m[y0:rows[-1] + 1, x0:cols[-1] + 1]
    pad = np.zeros((crop.shape[0] + 2, crop.shape[1] + 2), np.int16)
    pad[1:-1, 1:-1] = crop
    step = pad.shape[1]
    starts = np.flatnonzero((pad[:, 1:] == 1) & (pad[:, :-1] == 0))
    img = pad.ravel().tolist()
    found = []
    row, last, left = -1, 0, 0
    for s in starts.tolist():
        i0 = s + 1 + s // (step - 1)  # flat index of the start pixel
        if i0 // step != row:  # a new row: nothing visited to the left yet
            row, last, left = i0 // step, i0 - i0 % step, 0
        # the nearest visited pixel left of i0: in [last, i0), else the one
        # left of the previous candidate (a contour started at ``last``
        # marks nothing left of it on this row)
        for v in reversed(img[last:i0]):
            if v > 1 or v < 0:
                left = v
                break
        last = i0
        if img[i0] != 1 or left > 1:  # visited, or inside an outer border
            continue
        y, x = divmod(i0, step)
        pts = _follow(img, step, i0, x, y)
        found.append(([(px + x0 - 1, py + y0 - 1) for px, py in pts],
                      _shoelace(pts)))
    return found


def outer_contours(binary: np.ndarray) -> list[np.ndarray]:
    """The outer contours of the nonzero pixels of a 2-D array, as
    ``cv2.findContours(m, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` returns
    them: (P, 2) int32 (x, y) vertex arrays, the last found first. A
    contour starts where a raster scan meets an unvisited foreground
    pixel after a background one, and is followed only where the nearest
    visited border pixel to its left on that row is not one that a border
    left to the right (OpenCV's test for lying inside an outer border)."""
    return [np.asarray(pts, np.int32).reshape(-1, 2)
            for pts, _ in _outer_borders(binary)[::-1]]


def contour_area(c: np.ndarray) -> float:
    """|shoelace area| of a closed polygon, as ``cv2.contourArea``."""
    return _shoelace(np.asarray(c, np.int64).reshape(-1, 2).tolist())


def masks_to_polygons(
    masks: np.ndarray,  # (M, Hm, Wm) float masks (host numpy)
    count: int,
    gain: float,
    pad: tuple[float, float],
    orig_hw: tuple[int, int],
    input_hw: tuple[int, int],
    threshold: float = 0.5,
) -> list[np.ndarray]:
    """The largest outer contour of each of the first ``count`` masks
    (above ``threshold``), mapped prototype grid -> model input ->
    original frame and clipped to the frame: one (P, 2) float32 array per
    detection, (0, 2) for an empty mask. Ties in area go to the contour
    that ``cv2.findContours`` lists first."""
    out: list[np.ndarray] = []
    hm, wm = masks.shape[1:]
    sx_in = input_hw[1] / wm
    sy_in = input_hw[0] / hm
    for i in range(count):
        borders = _outer_borders(masks[i] > threshold)[::-1]  # cv2's order
        if not borders:
            out.append(np.zeros((0, 2), np.float32))
            continue
        pts = max(borders, key=lambda b: b[1])[0]
        c = np.asarray(pts, np.float32).reshape(-1, 2)
        c[:, 0] = (c[:, 0] * sx_in - pad[0]) / gain
        c[:, 1] = (c[:, 1] * sy_in - pad[1]) / gain
        c[:, 0] = np.clip(c[:, 0], 0, orig_hw[1])
        c[:, 1] = np.clip(c[:, 1], 0, orig_hw[0])
        out.append(c)
    return out
