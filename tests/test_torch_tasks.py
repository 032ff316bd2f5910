"""The pose and segment task operations of the port against the JAX
package, the cv2-free mask polygons against cv2, and the quality bars of
tests/test_trained_seg_pose.py run through the port.

Tolerances: keypoints 1e-4 px and masks 1e-6 from the same inputs
(float32, summed in another order); polygons equal vertex for vertex,
as lists and in order; Pipeline.predict against the JAX Pipeline on the
trained synth160 assets: boxes and keypoints within 1e-3 px, masks
within 1e-5, equal polygons.
"""

import importlib
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.tools.train import POSE_KPT_COLORS
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.ops import keypoints as tkp
from strongsort_yolo_tpu_torch.ops import masks as tmasks
from strongsort_yolo_tpu_torch.pipeline import Pipeline

jkp = importlib.import_module("strongsort_yolo_tpu.ops.keypoints")
jmasks = importlib.import_module("strongsort_yolo_tpu.ops.masks")

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
SEG = os.path.join(ASSETS, "yolov8n_seg_synth160.npz")
POSE = os.path.join(ASSETS, "yolov8n_pose_synth160.npz")
POSE11 = os.path.join(ASSETS, "yolo11n_pose_synth160.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_decode_and_scale_keypoints_match_jax():
    rng = np.random.default_rng(0)
    m, nk = 37, 17
    raw = rng.normal(0, 2, (m, nk * 3)).astype(np.float32)
    anchors = rng.integers(0, 80, (m, 2)).astype(np.float32) + 0.5
    strides = rng.choice([8.0, 16.0, 32.0], (m, 1)).astype(np.float32)
    want = np.asarray(jkp.decode_keypoints(jnp.asarray(raw), jnp.asarray(anchors),
                                           jnp.asarray(strides), nk))
    got = tkp.decode_keypoints(torch.from_numpy(raw), torch.from_numpy(anchors),
                               torch.from_numpy(strides), nk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # batched rows decode as the rows one frame at a time
    got2 = tkp.decode_keypoints(torch.from_numpy(raw).reshape(1, m, -1),
                                torch.from_numpy(anchors)[None],
                                torch.from_numpy(strides)[None], nk)[0].numpy()
    np.testing.assert_array_equal(got2, got)
    gain, pad, hw = 0.3333333, (0.0, 140.0), (1080, 1920)
    want = np.asarray(jkp.scale_keypoints(
        jnp.asarray(want), jnp.float32(gain), jnp.asarray(pad, jnp.float32),
        jnp.asarray(hw, jnp.float32)))
    got = tkp.scale_keypoints(torch.from_numpy(got), gain, pad, hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert got[..., 0].max() <= hw[1] and got[..., 1].min() >= 0


def test_process_masks_matches_jax():
    rng = np.random.default_rng(1)
    m, nm, hm, wm = 12, 32, 40, 40
    coefs = rng.normal(0, 1, (m, nm)).astype(np.float32)
    proto = rng.normal(0, 1, (hm, wm, nm)).astype(np.float32)
    xy = rng.uniform(-10, 150, (m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 80, (m, 2))], 1).astype(np.float32)
    boxes[0] = [40.0, 40.0, 80.0, 80.0]  # edges on pixel boundaries
    boxes[1] = 0.0  # a padding row
    want = np.asarray(jmasks.process_masks(jnp.asarray(coefs), jnp.asarray(proto),
                                           jnp.asarray(boxes), (160, 160)))
    got = tmasks.process_masks(torch.from_numpy(coefs),
                               torch.from_numpy(proto).permute(2, 0, 1),
                               torch.from_numpy(boxes), (160, 160)).numpy()
    assert got.shape == want.shape == (m, hm, wm)
    np.testing.assert_array_equal(got > 0, want > 0)  # the same crop
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[1].any()


def _blob_masks(seed, n=40, size=(40, 48)):
    """Seeded masks: ellipses, ellipses with holes, several components,
    masks touching every border, noise, single pixels, empty."""
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        m = np.zeros(size, np.float32)
        for _ in range(1 + i % 4):
            cx, cy = rng.uniform(-5, w + 5), rng.uniform(-5, h + 5)
            rx, ry = rng.uniform(1, 20, 2)
            e = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
            m = np.where(e, rng.uniform(0.6, 1.0), m) if i % 3 else np.where(
                e, 1.0 - m, m)  # every third mask: xor, so holes
        out.append(m)
    noise = rng.uniform(0, 1, (6, h, w)).astype(np.float32)
    out += list(noise)
    single = np.zeros(size, np.float32)
    single[h // 2, w // 3] = 0.9
    full = np.full(size, 0.8, np.float32)
    out += [single, full, np.zeros(size, np.float32)]
    return np.stack(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_outer_contours_equal_cv2(seed):
    for m in _blob_masks(seed) > 0.5:
        want, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = tmasks.outer_contours(m)
        assert [c.tolist() for c in got] == [c.reshape(-1, 2).tolist()
                                             for c in want]
        for c in got:
            assert tmasks.contour_area(c) == cv2.contourArea(c[:, None])


@pytest.mark.parametrize("seed", [3, 4])
def test_masks_to_polygons_equal_jax(seed):
    masks = _blob_masks(seed)
    args = (len(masks) - 2, 0.3333333, (0.0, 140.0), (1080, 1920), (160, 192))
    want = jmasks.masks_to_polygons(masks, *args)
    got = tmasks.masks_to_polygons(masks, *args)
    assert len(got) == len(want) == len(masks) - 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _kw(path):
    return dict(weights=path, imgsz=160, conf=0.3, iou=0.4, max_det=8,
                half=False)


def _pipes(path):
    return (JPipeline(JDetectorConfig(**_kw(path)), track_slots=8,
                      tracker_max_dets=8),
            Pipeline(DetectorConfig(**_kw(path)), track_slots=8,
                     tracker_max_dets=8, device="cpu"))


def assert_same_results(want, got, what=""):
    """Rows, ids, boxes within 1e-3 px, keypoints within 1e-3 px (conf
    1e-5), masks within 1e-5 and equal polygons."""
    assert len(got) == len(want), what
    np.testing.assert_allclose(got.boxes.xyxy, want.boxes.xyxy, atol=1e-3,
                               err_msg=what)
    if want.boxes.id is not None:
        np.testing.assert_array_equal(got.boxes.id, want.boxes.id)
    assert (got.keypoints is None) == (want.keypoints is None)
    if want.keypoints is not None:
        np.testing.assert_allclose(got.keypoints.xy, want.keypoints.xy,
                                   atol=1e-3, err_msg=what)
        np.testing.assert_allclose(got.keypoints.conf, want.keypoints.conf,
                                   atol=1e-5, err_msg=what)
    assert (got.masks is None) == (want.masks is None)
    if want.masks is not None:
        np.testing.assert_allclose(got.masks.data, want.masks.data, atol=1e-5,
                                   err_msg=what)
        assert len(got.masks.xy) == len(want.masks.xy)
        for a, b in zip(got.masks.xy, want.masks.xy):
            np.testing.assert_array_equal(a, b, err_msg=what)


def _ellipse_frame(size=320):
    """tests/test_trained_seg_pose.py's ellipse on noise."""
    rng = np.random.default_rng(3)
    frame = (rng.uniform(0, 0.3, (size, size, 3)) * 255).astype(np.uint8)
    cx, cy, rw, rh = 170.0, 150.0, 52.0, 38.0
    yy, xx = np.mgrid[0:size, 0:size]
    ell = ((xx - cx) / rw) ** 2 + ((yy - cy) / rh) ** 2 <= 1.0
    frame[ell] = int((0.5 + 0.16 * 1) * 255)
    return frame, ell, (cx - rw, cy - rh, cx + rw, cy + rh)


def _dots_frame():
    """tests/test_trained_seg_pose.py's box with five coloured dots."""
    rng = np.random.default_rng(11)
    size = 320
    frame = (rng.uniform(0, 0.3, (size, size, 3)) * 255).astype(np.uint8)
    x1, y1, w, h = 90.0, 70.0, 120.0, 100.0
    frame[int(y1):int(y1 + h), int(x1):int(x1 + w)] = int(0.5 * 255)
    gt = []
    for k in range(5):
        while True:
            kx = x1 + rng.uniform(0.15, 0.85) * w
            ky = y1 + rng.uniform(0.15, 0.85) * h
            if not gt or min(max(abs(px - kx), abs(py - ky))
                             for px, py in gt) > 18:
                break
        iy, ix = int(ky), int(kx)
        frame[iy - 7:iy + 8, ix - 7:ix + 8] = (
            POSE_KPT_COLORS[k][::-1] * 255).astype(np.uint8)
        gt.append((kx, ky))
    return frame, np.asarray(gt)


def test_trained_seg_mask_is_the_ellipse_not_the_box():
    """The bar of test_trained_seg_pose.py, through the port, and the same
    result as the JAX Pipeline.predict."""
    jpipe, pipe = _pipes(SEG)
    frame, ell, box = _ellipse_frame()
    r = pipe.predict(frame)
    assert_same_results(jpipe.predict(frame), r, "seg predict")
    assert len(r.boxes) >= 1
    best = int(np.argmax(r.boxes.conf))
    x1, y1, x2, y2 = r.boxes.xyxy[best]
    assert abs(x1 - box[0]) < 16 and abs(y2 - box[3]) < 16
    poly = np.asarray(r.masks.xy[best], np.int32)
    assert len(poly) >= 3
    pred = np.zeros(frame.shape[:2], np.uint8)
    cv2.fillPoly(pred, [poly], 1)
    pred = pred.astype(bool)
    box_mask = np.zeros_like(pred)
    bx = [int(v) for v in box]
    box_mask[bx[1]:bx[3], bx[0]:bx[2]] = True

    def iou(a, b):
        return (a & b).sum() / max((a | b).sum(), 1)

    iou_ell, iou_box = iou(pred, ell), iou(pred, box_mask)
    assert iou_ell > 0.75, (iou_ell, iou_box)
    assert iou_ell > iou_box, (iou_ell, iou_box)


@pytest.mark.parametrize("ckpt", [POSE, POSE11], ids=["yolov8n-pose", "yolo11n-pose"])
def test_trained_pose_finds_drawn_dots(ckpt):
    jpipe, pipe = _pipes(ckpt)
    frame, gt = _dots_frame()
    r = pipe.predict(frame)
    assert_same_results(jpipe.predict(frame), r, "pose predict")
    assert len(r.boxes) >= 1
    best = int(np.argmax(r.boxes.conf))
    kxy, kconf = r.keypoints.xy[best], r.keypoints.conf[best]
    assert kxy.shape == (5, 2)
    err = np.linalg.norm(kxy - gt, axis=-1)
    assert float(err.mean()) < 10.0, err
    assert float(kconf.mean()) > 0.5, kconf
    masked = r.keypoints.xy_masked
    assert masked.shape == r.keypoints.xy.shape
    assert len(list(r.keypoints)) == len(r.boxes)
