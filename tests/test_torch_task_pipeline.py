"""Pipeline.track, Pipeline.track_chunk and BatchedPipeline.step of the
port with the trained pose and segment synth160 assets against the JAX
Pipeline on the same rendered clips: the same rows and track ids, boxes
and keypoints within 1e-3 px, masks within 1e-5 and the same polygons
(float32 on both sides, half=False; the tolerances of
tests/test_torch_tasks.py).
"""

import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.tools.train import POSE_KPT_COLORS
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from test_torch_tasks import assert_same_results

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
S, T, SIZE = 2, 6, 320


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render(task: str, seed: int) -> np.ndarray:
    """(S, T, 320, 320, 3) uint8 BGR: per stream two objects moving a few
    px per frame on noise; ellipses (class 1 shade) for the segment
    model, boxes (class 0 shade) with five coloured dots for the pose
    models, as they were trained."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    out = np.empty((S, T, SIZE, SIZE, 3), np.uint8)
    for s in range(S):
        objs = [(rng.uniform(60, 120), rng.uniform(60, 250),
                 rng.uniform(-4, 4), rng.uniform(-4, 4)) for _ in range(2)]
        objs[1] = (objs[1][0] + 130, *objs[1][1:])
        dots = rng.uniform(0.15, 0.85, (5, 2))
        for t in range(T):
            f = (rng.uniform(0, 0.3, (SIZE, SIZE, 3)) * 255).astype(np.uint8)
            for cx, cy, vx, vy in objs:
                cx, cy = cx + vx * t, cy + vy * t
                if task == "segment":
                    ell = ((xx - cx) / 48) ** 2 + ((yy - cy) / 34) ** 2 <= 1
                    f[ell] = int((0.5 + 0.16) * 255)
                else:
                    x1, y1 = int(cx - 50), int(cy - 40)
                    f[y1:y1 + 80, x1:x1 + 100] = int(0.5 * 255)
                    for k, (u, v) in enumerate(dots):
                        ix, iy = int(x1 + u * 100), int(y1 + v * 80)
                        f[iy - 4:iy + 5, ix - 4:ix + 5] = (
                            POSE_KPT_COLORS[k][::-1] * 255).astype(np.uint8)
            out[s, t] = f
    return out


CASES = [("yolov8n_seg_synth160", "segment"),
         ("yolov8n_pose_synth160", "pose"),
         ("yolo11n_pose_synth160", "pose")]


@pytest.mark.parametrize("asset,task", CASES)
def test_track_and_batched_step_match_jax(asset, task):
    path = os.path.join(ASSETS, asset + ".npz")
    kw = dict(weights=path, imgsz=160, conf=0.3, iou=0.4, max_det=8,
              half=False)
    jpipe = JPipeline(JDetectorConfig(**kw),
                      tracker=JByteTrackConfig(gmc_method="none"),
                      track_slots=8, tracker_max_dets=8)
    pipe = Pipeline(DetectorConfig(**kw), tracker=ByteTrackConfig(gmc_method="none"),
                    track_slots=8, tracker_max_dets=8, device="cpu")
    clip = render(task, seed=len(asset))
    rows = 0
    for t in range(T):  # one stream through track
        want, got = jpipe.track(clip[0, t]), pipe.track(clip[0, t])
        assert_same_results(want, got, f"track t={t}")
        rows += len(got)
    assert rows >= 2 * (T - 2)
    extra = "masks" if task == "segment" else "keypoints"
    assert getattr(got, extra) is not None and len(getattr(got, extra)) == len(got)
    jb = jpipe.track_batch_prepare(S, (SIZE, SIZE))
    tb = BatchedPipeline(pipe, S, (SIZE, SIZE))
    for t in range(T):  # S streams through the batched step
        for s, (want, got) in enumerate(zip(jb.step(clip[:, t]),
                                            tb.step(clip[:, t]))):
            assert_same_results(want, got, f"step t={t} s={s}")


def test_track_chunk_equals_track_calls():
    """T frames of one stream through one track_chunk give the Results of
    T track calls, keypoints included."""
    path = os.path.join(ASSETS, "yolo11n_pose_synth160.npz")
    kw = dict(weights=path, imgsz=160, conf=0.3, iou=0.4, max_det=8,
              half=False)
    pipe = Pipeline(DetectorConfig(**kw), tracker="bytetrack.yaml",
                    track_slots=8, tracker_max_dets=8, device="cpu")
    clip = render("pose", seed=5)[1]
    singles = [pipe.track(f) for f in clip]
    pipe.reset()
    chunk = pipe.track_chunk(clip)
    assert sum(len(r) for r in chunk) >= 2 * (T - 2)
    for t, (a, b) in enumerate(zip(singles, chunk)):
        assert_same_results(a, b, f"chunk t={t}")
