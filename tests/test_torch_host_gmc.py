"""The host camera-motion estimators (``track/gmc.py``: BoT-SORT's
``sparseOptFlow``, StrongSORT's ``ecc``) against the JAX package's, and
the pipeline estimating them itself where the caller passes no warps, as
the JAX ``Pipeline`` does: ``track``, ``track_chunk`` and
``BatchedPipeline.step``, on a panned clip with the trained synth160
detector (imgsz 160, float32).

Bars: warps bit-identical (the same OpenCV calls on the same frames); per
frame and stream equal row counts and track ids and boxes within 1e-3 px,
as the other pipeline parity tests hold. A last case shows that the clip
tells the repair apart: without camera-motion compensation the same
frames give other tracks.
"""

import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track import gmc as jgmc
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track import gmc as tgmc
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from test_torch_flow_pipeline import panned_clip

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
DET = dict(weights=CKPT, imgsz=160, conf=0.3, iou=0.4, max_det=16, half=False)
SIZES = dict(track_slots=16, tracker_max_dets=16)
PAN = (12, -6)  # frame px per frame: whole pixels at the estimators' half size
T = 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    return panned_clip(T, seed=3, pan=PAN)


def _kw(tracker):
    kw = dict(SIZES)
    if tracker == "strongsort.yaml":
        kw.update(reid_weights=OSNET, reid_topk=16)
    return kw


def _pipes(tracker):
    return (JPipeline(JDetectorConfig(**DET), tracker=tracker, **_kw(tracker)),
            Pipeline(DetectorConfig(**DET), tracker=tracker, device="cpu",
                     **_kw(tracker)))


def _assert_same(want, got, what):
    assert len(got) == len(want), what
    np.testing.assert_array_equal(got.boxes.id, want.boxes.id, err_msg=what)
    np.testing.assert_allclose(got.boxes.xyxy, want.boxes.xyxy, atol=1e-3,
                               err_msg=what)


@pytest.mark.parametrize("method", ["sparseOptFlow", "ecc"])
def test_warps_equal_jax(method, clip):
    want, got = jgmc.make_gmc(method), tgmc.make_gmc(method)
    moved = 0.0
    for t, frame in enumerate(clip):
        w, g = want.apply(frame), got.apply(frame)
        assert g.dtype == np.float32 and g.shape == (2, 3)
        np.testing.assert_array_equal(g, w, err_msg=f"{method} frame {t}")
        moved += float(np.abs(g[:, 2]).sum())
    assert moved > 10.0 * T  # the pan was seen
    got.reset()
    np.testing.assert_array_equal(got.apply(clip[1]), tgmc.IDENTITY_WARP)
    assert np.array_equal(tgmc.make_gmc("none").apply(clip[0]),
                          tgmc.IDENTITY_WARP)


@pytest.mark.parametrize("tracker", ["botsort.yaml", "strongsort.yaml"])
def test_track_estimates_warps_as_jax(tracker, clip):
    jp, tp = _pipes(tracker)
    assert type(tp.host_gmc).__name__ == "SparseOptFlowGMC"
    rows = 0
    for t, frame in enumerate(clip):
        got = tp.track(frame)
        _assert_same(jp.track(frame), got, f"{tracker} frame {t}")
        rows += len(got)
    assert rows >= 3 * (T - 3)  # StrongSORT confirms at the third hit
    tp.reset()
    jp.reset()
    _assert_same(jp.track(clip[4]), tp.track(clip[4]), "after reset")


def test_track_chunk_estimates_warps_as_jax(clip):
    jp, tp = _pipes("botsort.yaml")
    for t in range(2):
        _assert_same(jp.track(clip[t]), tp.track(clip[t]), f"frame {t}")
    for t, (w, g) in enumerate(zip(jp.track_chunk(clip[2:]),
                                   tp.track_chunk(clip[2:]))):
        _assert_same(w, g, f"chunk frame {t + 2}")


def test_batched_estimates_warps_as_jax(clip):
    jp, tp = _pipes("botsort.yaml")
    other = panned_clip(T, seed=5, pan=(-6, 6))
    frames = np.stack([clip, other], 1)  # (T, S=2, H, W, 3)
    jb = jp.track_batch_prepare(2, clip.shape[1:3])
    tb = BatchedPipeline(tp, 2, clip.shape[1:3])
    for t in range(T):
        if t == 5:  # a stream restarts: its estimator forgets its frame
            jb.reset_stream(1)
            tb.reset_stream(1)
        for s, (w, g) in enumerate(zip(jb.step(frames[t]),
                                       tb.step(frames[t]))):
            _assert_same(w, g, f"tick {t} stream {s}")
    np.testing.assert_array_equal(tb.compute_warps(frames[0]),
                                  jb.compute_warps(frames[0]))


def test_without_compensation_the_tracks_differ(clip):
    """The clip tells the repair apart: BoT-SORT with gmc 'none', the
    port's behaviour before host warps, tracks these frames otherwise."""
    tp = Pipeline(DetectorConfig(**DET), device="cpu", tracker="botsort.yaml",
                  **SIZES)
    off = Pipeline(DetectorConfig(**DET), device="cpu", tracker=ByteTrackConfig(
        tracker_type="botsort", gmc_method="none"), **SIZES)
    differ = 0
    for frame in clip:
        a, b = tp.track(frame), off.track(frame)
        differ += (len(a) != len(b) or not np.array_equal(a.boxes.id, b.boxes.id)
                   or not np.allclose(a.boxes.xyxy, b.boxes.xyxy, atol=1.0))
    assert differ >= T // 2, differ
