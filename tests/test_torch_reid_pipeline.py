"""The port's ReID tracking path (detect -> NMS -> embed -> StrongSORT or
BoT-SORT with ReID) against the JAX package on the same frames and the
same weights: the trained synth160 detector and the trained OSNet
``assets/osnet_x0_25_synth.npz``, half=False on both sides.

The port sizes its crop batch from each tick's real detection counts;
the JAX BatchedPipeline embeds a fixed width without ``auto_topk`` and a
packed, count-sized batch with it. All must give the same tracks: per
stream and tick equal row counts, equal track ids and classes, boxes
within 1e-3 px and confidences within 1e-5 (float32 model, crops and
Kalman algebra summed in another order; the embeddings then differ
below 1e-4 and decide no assignment here).
"""

import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.media.video import SyntheticDetSource
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu.track.strongsort import StrongSortConfig as JStrongSortConfig
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
DET = dict(weights=CKPT, imgsz=160, conf=0.3, iou=0.4, max_det=16, half=False)
SIZES = dict(track_slots=16, tracker_max_dets=16, reid_topk=16,
             reid_weights=OSNET)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipes(jtracker, ttracker):
    return (JPipeline(JDetectorConfig(**DET), tracker=jtracker, **SIZES),
            Pipeline(DetectorConfig(**DET), tracker=ttracker, device="cpu",
                     **SIZES))


def _video(s, t):
    """(S, T, 320, 320, 3): moving shaded rectangles, 3 or 4 per stream."""
    srcs = [SyntheticDetSource(num_frames=t, size=(320, 320),
                               num_objects=3 + i % 2, seed=i + 1)
            for i in range(s)]
    return np.stack([np.stack(list(src)) for src in srcs])


def _assert_same(want, got, t):
    for s, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b), f"t={t} s={s}: {len(a)} != {len(b)}"
        np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3,
                                   err_msg=f"t={t} s={s}")
        np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
        np.testing.assert_array_equal(b.boxes.cls, a.boxes.cls)
        np.testing.assert_allclose(b.boxes.conf, a.boxes.conf, atol=1e-5)


def test_strongsort_track_vs_jax():
    """Single stream, ``Pipeline.track``: the fixed-width JAX embed."""
    jp, tp = _pipes(JStrongSortConfig(gmc_method="none"),
                    StrongSortConfig(gmc_method="none"))
    frames = _video(1, 10)[0]
    rows = 0
    for t, f in enumerate(frames):
        got = tp.track(f)
        _assert_same([jp.track(f)], [got], t)
        rows += len(got)
    assert rows >= 3 * (10 - 3)  # confirmed from the third hit on


@pytest.mark.parametrize("auto_topk", [False, True])
def test_strongsort_batched_vs_jax(auto_topk):
    S, T = 2, 8
    jp, tp = _pipes(JStrongSortConfig(gmc_method="none"),
                    StrongSortConfig(gmc_method="none"))
    jb = jp.track_batch_prepare(S, (320, 320), auto_topk=auto_topk)
    tb = BatchedPipeline(tp, S, (320, 320))
    frames = _video(S, T)
    rows = 0
    for t in range(T):
        got = tb.step(frames[:, t])
        _assert_same(jb.step(frames[:, t]), got, t)
        rows += sum(len(r) for r in got)
    assert rows >= 7 * (T - 3)


def test_strongsort_batched_with_warps_vs_jax():
    """StrongSORT's default ECC camera-motion compensation: the warps come
    from the JAX ``BatchedPipeline.compute_warps`` and go to both sides,
    which holds the XYAH ``apply_warp``."""
    S, T = 2, 6
    jp, tp = _pipes("strongsort.yaml", "strongsort.yaml")
    jb = jp.track_batch_prepare(S, (320, 320))
    tb = BatchedPipeline(tp, S, (320, 320))
    frames = _video(S, T)
    moved = 0.0
    for t in range(T):
        warps = jb.compute_warps(frames[:, t])
        moved += float(np.abs(warps - np.eye(2, 3)).sum())
        _assert_same(jb.step(frames[:, t], warps), tb.step(frames[:, t], warps),
                     t)
    assert moved > 0.0


def test_botsort_reid_batched_vs_jax():
    S, T = 2, 8
    kw = dict(tracker_type="botsort", with_reid=True, gmc_method="none")
    jp, tp = _pipes(JByteTrackConfig(**kw), ByteTrackConfig(**kw))
    jb = jp.track_batch_prepare(S, (320, 320))
    tb = BatchedPipeline(tp, S, (320, 320))
    frames = _video(S, T)
    for t in range(T):
        _assert_same(jb.step(frames[:, t]), tb.step(frames[:, t]), t)
    assert tb.states.feat.shape == (S, 16, 512)
    assert (tb.states.feat.norm(dim=-1) > 0.99).sum() >= 7


def test_embed_sizes_the_crop_batch_from_the_counts():
    """Slots per stream: min(count, reid_topk, tracker_max_dets) rounded
    up to 8; padding slots carry a zero feature."""
    _, tp = _pipes(JStrongSortConfig(gmc_method="none"),
                   StrongSortConfig(gmc_method="none"))
    frames = _video(3, 1)[:, 0]
    det = tp.detect(torch.from_numpy(frames))
    counts = det.count.tolist()
    slots = tp.embed_slots(det.count.numpy())
    assert slots.shape[1] == sum(-(-c // 8) * 8 for c in counts)
    assert slots[2].sum() == sum(counts)
    feats = tp.embed(torch.from_numpy(frames), det)
    norms = feats.norm(dim=-1)
    for s, c in enumerate(counts):
        assert (norms[s, :c] > 0.99).all() and (norms[s, c:] == 0).all()
