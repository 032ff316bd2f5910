"""``gmc_method="flow_tpu"`` through the port's entry points against the
JAX package: ``Pipeline.track``, ``BatchedPipeline.step`` (with
``reset_stream``) and ``Pipeline.track_chunk``, BoT-SORT, on a short
panned clip with the trained synth160 detector (imgsz 160, float32).

The JAX side runs ``estimate_warp`` with ``method="pallas_interpret"``
(patched in at trace time), so both sides compute the TPU kernel's math;
its plain estimate and the port's agree to ~1e-5 px. Per frame and
stream: equal row counts and track ids, boxes within 1e-3 px (float32
model, and the Kalman algebra summed in another order), as the other
pipeline parity tests hold. Also: ``track_chunk`` equals T ``track``
calls, explicit warps are refused with ``flow_tpu``, and tracker YAML
files with ``gmc_method: flow_tpu`` load as in the JAX package.
"""

import functools
import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.config import load_tracker_config as j_load_tracker_config
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track import gmc_tpu
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu_torch.config import DetectorConfig, load_tracker_config
from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import lk_pyramid
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
HW = (240, 320)
DET = dict(weights=CKPT, imgsz=160, conf=0.3, iou=0.4, max_det=16, half=False)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_pallas_lk(monkeypatch):
    """The JAX pipeline's in-step estimate through the Pallas LK kernel in
    interpret mode (looked up when the step is traced)."""
    monkeypatch.setattr(
        gmc_tpu, "estimate_warp",
        functools.partial(gmc_tpu.estimate_warp, method="pallas_interpret"),
    )


def panned_clip(num_frames: int, seed: int = 1, pan=(4, -3)) -> np.ndarray:
    """(T, 240, 320, 3) uint8: a static noise background and three shaded
    rectangles (the synth160 task), the whole scene panned by ``pan`` px
    per frame (np.roll: an exact translation of the background)."""
    h, w = HW
    rng = np.random.default_rng(seed)
    bg = (rng.uniform(0.0, 0.3, (h, w, 3)) * 255).astype(np.uint8)
    objs = [(float(rng.uniform(20, 150)), float(rng.uniform(20, 100)),
             float(rng.uniform(50, 80)), float(rng.uniform(45, 70)),
             float(rng.uniform(-1.5, 1.5)), float(rng.uniform(-1.0, 1.0)), c)
            for c in range(3)]
    frames = []
    for t in range(num_frames):
        dx, dy = pan[0] * t, pan[1] * t
        f = np.roll(bg, (dy, dx), axis=(0, 1)).copy()
        for x, y, ow, oh, vx, vy, cls in objs:
            x1 = int(np.clip(x + vx * t + dx, 0, w - ow))
            y1 = int(np.clip(y + vy * t + dy, 0, h - oh))
            f[y1:y1 + int(oh), x1:x1 + int(ow)] = int((0.5 + 0.16 * cls) * 255)
        frames.append(f)
    return np.stack(frames)


def _pipes(gmc="flow_tpu"):
    kw = dict(track_slots=16, tracker_max_dets=16)
    jp = JPipeline(JDetectorConfig(**DET),
                   tracker=JByteTrackConfig(tracker_type="botsort",
                                            gmc_method=gmc), **kw)
    tp = Pipeline(DetectorConfig(**DET),
                  tracker=ByteTrackConfig(tracker_type="botsort",
                                          gmc_method=gmc), device="cpu", **kw)
    return jp, tp


def _assert_same(want, got, where):
    assert len(want) == len(got), f"{where}: {len(want)} != {len(got)} rows"
    np.testing.assert_array_equal(got.boxes.id, want.boxes.id, err_msg=where)
    np.testing.assert_allclose(got.boxes.xyxy, want.boxes.xyxy, atol=1e-3,
                               err_msg=where)


def test_track_and_chunk_vs_jax(jax_pallas_lk):
    """Pipeline.track over 6 frames, then track_chunk over 4 and 2 more:
    the flow state carries from track into the chunks, as in JAX."""
    frames = panned_clip(12)
    jp, tp = _pipes()
    before = lk_pyramid.launches
    rows = 0
    for t in range(6):
        want, got = jp.track(frames[t]), tp.track(frames[t])
        _assert_same(want, got, f"track t={t}")
        rows += len(got)
    for lo, hi in ((6, 10), (10, 12)):
        want, got = jp.track_chunk(frames[lo:hi]), tp.track_chunk(frames[lo:hi])
        for k, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"chunk t={lo + k}")
            rows += len(b)
    assert rows >= 3 * 9  # the objects are tracked
    # one estimate per track call and per chunk, on the CPU the plain version
    assert lk_pyramid.launches == before
    assert tp.gmc.prev.shape == (gmc_tpu.BASE_H, gmc_tpu.BASE_W)
    tp.reset()
    assert tp.gmc.prev is None


def test_batched_step_vs_jax(jax_pallas_lk):
    """S=2 streams panned differently, 8 ticks; stream 1 is reset at tick
    4, so its next warp is the identity on both sides."""
    a, b = panned_clip(8, seed=1, pan=(4, -3)), panned_clip(8, seed=2, pan=(-3, 2))
    frames = np.stack([a, b], 1)  # (T, S, ...)
    jp, tp = _pipes()
    jb = jp.track_batch_prepare(2, HW)
    tb = BatchedPipeline(tp, 2, HW)
    for t in range(len(frames)):
        if t == 4:
            jb.reset_stream(1)
            tb.reset_stream(1)
            assert tb.has_prev.tolist() == [True, False]
        want, got = jb.step(frames[t]), tb.step(frames[t])
        for s in range(2):
            _assert_same(want[s], got[s], f"t={t} s={s}")
        assert tb.has_prev.all() and tb.has_prev.device == tp.device
        w = tb.last_warps.numpy()
        if t in (0, 4):  # stream 1 without a previous frame
            np.testing.assert_array_equal(w[1], np.eye(2, 3))
        if t > 0:  # more than half the (4, -3) pan: LK falls short of it
            # on i.i.d. noise texture, as the JAX estimate does
            assert w[0, 0, 2] > 2.0 and w[0, 1, 2] < -1.5, w[0]


def _rows(results):
    return [(r.boxes.id.copy(), r.boxes.xyxy.copy()) for r in results]


@pytest.mark.parametrize("gmc", ["flow_tpu", "sparseOptFlow"])
def test_track_chunk_equals_track_calls(gmc):
    """T=5 frames as one chunk and as five track calls, after two
    frames tracked one by one; a caller-warps tracker gets the same
    (T, 2, 3) warps both ways."""
    frames = panned_clip(7, seed=3)
    warps = np.tile(np.eye(2, 3, dtype=np.float32), (7, 1, 1))
    warps[:, :, 2] = (4.0, -3.0)
    kw = dict(tracker=ByteTrackConfig(tracker_type="botsort", gmc_method=gmc),
              track_slots=16, tracker_max_dets=16, device="cpu")
    one, chunk = Pipeline(DetectorConfig(**DET), **kw), Pipeline(
        DetectorConfig(**DET), **kw)
    ws = (lambda t: None) if gmc == "flow_tpu" else (lambda t: warps[t])
    for t in range(2):
        one.track(frames[t], ws(t))
        chunk.track(frames[t], ws(t))
    want = _rows([one.track(frames[t], ws(t)) for t in range(2, 7)])
    got = _rows(chunk.track_chunk(
        frames[2:], None if gmc == "flow_tpu" else warps[2:]))
    assert sum(len(i) for i, _ in want) > 0
    for (wi, wb), (gi, gb) in zip(want, got):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gb, wb, atol=1e-4)


def test_flow_refuses_explicit_warps():
    _, tp = _pipes()
    frame = panned_clip(1)
    eye = np.eye(2, 3, dtype=np.float32)
    with pytest.raises(ValueError, match="flow_tpu"):
        tp.track(frame[0], eye)
    with pytest.raises(ValueError, match="flow_tpu"):
        tp.track_chunk(frame, eye[None])
    with pytest.raises(ValueError, match="flow_tpu"):
        BatchedPipeline(tp, 1, HW).step(frame, eye[None])


@pytest.mark.parametrize("body", [
    "tracker_type: botsort\ngmc_method: flow_tpu\ntrack_buffer: 40\n",
    "tracker_type: strongsort\ngmc_method: flow_tpu\nmax_age: 50\n",
])
def test_tracker_yaml_loads_flow_tpu(tmp_path, body):
    path = tmp_path / "tracker.yaml"
    path.write_text(body)
    got, want = load_tracker_config(str(path)), j_load_tracker_config(str(path))
    assert got.gmc_method == want.gmc_method == "flow_tpu"
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
        f: getattr(want, f) for f in got.__dataclass_fields__}
