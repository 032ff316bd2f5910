"""The port's BatchedPipeline.step against the JAX BatchedPipeline on the
same frames and the same weights (JAX-initialised ones converted with
params_from_jax, and the trained synth160 checkpoint).

Per stream and tick: equal row counts, equal track ids, boxes within
1e-3 px (float32 model, decode and Kalman algebra summed in another
order), half=False on both sides. Also: a subprocess imports every
module of the port and finds no jax in sys.modules.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.media.video import SyntheticDetSource
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.models.porting import params_from_jax
from strongsort_yolo_tpu_torch.models.yolo import build_model
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
PKG = os.path.join(ROOT, "strongsort_yolo_tpu_torch")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(want, got, t):
    for s, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b), f"t={t} s={s}: {len(a)} != {len(b)}"
        np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3,
                                   err_msg=f"t={t} s={s}")
        np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
        np.testing.assert_array_equal(b.boxes.cls, a.boxes.cls)
        np.testing.assert_allclose(b.boxes.conf, a.boxes.conf, atol=1e-5)


def test_dryrun_serving_setup_vs_jax():
    """S=8 streams of 240x320 noise with one bright blob each, random
    yolov8n (JAX init, converted), ByteTrack, two lockstep ticks."""
    S, T = 8, 2
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (S, T, 240, 320, 3), dtype=np.uint8)
    for s in range(S):
        frames[s, :, 30 + 14 * s : 110 + 14 * s, 60:180] = (40, 180, 220)
    kw = dict(weights="yolov8n", imgsz=160, half=False, max_det=16)
    jpipe = JPipeline(JDetectorConfig(**kw), tracker="bytetrack.yaml",
                      track_slots=16, tracker_max_dets=16)
    tpipe = Pipeline(
        DetectorConfig(**kw), tracker="bytetrack.yaml", track_slots=16,
        tracker_max_dets=16, device="cpu",
        params=params_from_jax(jax.device_get(jpipe.params),
                               build_model("yolov8n")),
    )
    jb = jpipe.track_batch_prepare(S, (240, 320))
    tb = BatchedPipeline(tpipe, S, (240, 320))
    for t in range(T):
        _assert_same(jb.step(frames[:, t]), tb.step(frames[:, t]), t)


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort"])
def test_synth160_checkpoint_vs_jax(tracker):
    """The trained checkpoint on rendered video: real detections and
    tracks, two streams, ten ticks."""
    S, T = 2, 10
    srcs = [SyntheticDetSource(num_frames=T, size=(320, 320), num_objects=3,
                               seed=s + 1) for s in range(S)]
    frames = np.stack([np.stack(list(src)) for src in srcs])  # (S, T, ...)
    kw = dict(weights=CKPT, imgsz=160, conf=0.3, iou=0.4, max_det=16,
              half=False)
    jpipe = JPipeline(
        JDetectorConfig(**kw),
        tracker=JByteTrackConfig(tracker_type=tracker, gmc_method="none"),
        track_slots=16, tracker_max_dets=16,
    )
    tpipe = Pipeline(
        DetectorConfig(**kw),
        tracker=ByteTrackConfig(tracker_type=tracker, gmc_method="none"),
        track_slots=16, tracker_max_dets=16, device="cpu",
    )
    jb = jpipe.track_batch_prepare(S, (320, 320))
    tb = BatchedPipeline(tpipe, S, (320, 320))
    n_rows = 0
    for t in range(T):
        got = tb.step(frames[:, t])
        _assert_same(jb.step(frames[:, t]), got, t)
        n_rows += sum(len(r) for r in got)
    assert n_rows >= S * 3 * (T - 2)  # the objects are tracked


def test_step_requires_warps_when_gmc_is_on():
    pipe = Pipeline(
        DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16),
        tracker="botsort.yaml", track_slots=16, tracker_max_dets=16,
        device="cpu",
    )
    frames = np.zeros((2, 320, 320, 3), np.uint8)
    bp = BatchedPipeline(pipe, 2, (320, 320))
    with pytest.raises(ValueError, match="warps"):
        bp.step(frames)
    eye = np.tile(np.eye(2, 3, dtype=np.float32), (2, 1, 1))
    assert len(bp.step(frames, eye)) == 2
    bp.reset_stream(1)
    assert int(bp.states.frame_id[1]) == 0 and int(bp.states.frame_id[0]) == 1


def test_default_device_is_cuda_and_never_the_cpu(monkeypatch):
    """Without a device the pipeline runs on CUDA; where there is none it
    raises and names device="cpu" instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(DetectorConfig(weights=CKPT, imgsz=160, half=False,
                                max_det=16), tracker="bytetrack.yaml")


def test_port_imports_no_jax():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".").removesuffix(".__init__")
                mods.append(mod)
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'strongsort_yolo_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(" + repr(sorted(mods)) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the ReID slice included: models.osnet, ops.crops,
    # ops.cuda.crop_kernel, track.strongsort
    assert int(out.stdout.strip()) >= 24
    assert {"strongsort_yolo_tpu_torch.models.osnet",
            "strongsort_yolo_tpu_torch.models.porting",
            "strongsort_yolo_tpu_torch.models.yolov5",
            "strongsort_yolo_tpu_torch.models.yolov7",
            "strongsort_yolo_tpu_torch.ops.crops",
            "strongsort_yolo_tpu_torch.ops.cuda.crop_kernel",
            "strongsort_yolo_tpu_torch.track.strongsort"} <= set(mods)
