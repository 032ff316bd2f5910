"""Crowded-scene association through the port, against the JAX package:
the three scenes of ``tests/test_crowding.py`` (250 objects on 512
slots, lossless; the cut to 128 rows; slot overflow counted in
``dropped_births``) through the port's batched ``bytetrack_step`` beside
the JAX ``bytetrack_step``, and the ``truncated_dets`` counter through
the port's ``Pipeline``.

How the two are held together: the port solves with the TPU auction's
semantics (``auction_plain`` on the CPU, K3 on the card), the JAX step
on the CPU with its XLA auction. The scenes are well-separated boxes
with one clear best match each and no near-ties, where the two solvers
agree, so track ids, statuses, det indices and the counters must be
equal, and the Kalman states agree within rtol = atol = 1e-4 (float32,
the same algebra summed in another order), as in
``tests/test_torch_tracker.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.track import bytetrack as jbt
from strongsort_yolo_tpu.track.state import init_track_state as j_init
from strongsort_yolo_tpu_torch.track import bytetrack as tbt
from strongsort_yolo_tpu_torch.track.state import init_track_state as t_init

TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("mean", "cov", "track_id", "status", "activated", "score", "cls",
          "end_frame", "hits", "next_id", "frame_id", "dropped_births")


def _crowd_frame(t: int, n: int = 250):
    """The scene of tests/test_crowding.py: n well-separated 30x30 boxes
    on a 16x16 grid, drifting +2 px/frame, strictly ordered scores."""
    idx = np.arange(n)
    gx, gy = idx % 16, idx // 16
    x1 = gx * 60.0 + 2.0 * t
    y1 = gy * 60.0 + 2.0 * t
    boxes = np.stack([x1, y1, x1 + 30.0, y1 + 30.0], axis=1)
    scores = np.full((n,), 0.9, np.float32) - 1e-4 * idx
    return boxes.astype(np.float32), scores.astype(np.float32)


def _run_both(num_dets_fed: int, track_slots: int, frames: int = 3):
    """Feed the top ``num_dets_fed`` rows for ``frames`` frames to both
    steps, holding every frame's state and outputs equal; -> the port's
    (state, last outputs) for stream 0."""
    jcfg = jbt.ByteTrackConfig(tracker_type="bytetrack", gmc_method="none")
    tcfg = tbt.ByteTrackConfig(tracker_type="bytetrack", gmc_method="none")
    jstep = jax.jit(lambda st, b, s, c, v: jbt.bytetrack_step(st, b, s, c, v,
                                                               jcfg))
    jstate, tstate = j_init(track_slots), t_init(1, track_slots)
    tout = None
    for t in range(frames):
        boxes, scores = _crowd_frame(t)
        b, s = boxes[:num_dets_fed], scores[:num_dets_fed]
        c = np.zeros((num_dets_fed,), np.int32)
        v = np.ones((num_dets_fed,), bool)
        jstate, jout = jstep(jstate, jnp.asarray(b), jnp.asarray(s),
                             jnp.asarray(c), jnp.asarray(v))
        tstate, tout = tbt.bytetrack_step(
            tstate, *(torch.from_numpy(a[None]) for a in (b, s, c, v)), tcfg)
        for f in FIELDS:
            want = np.asarray(getattr(jstate, f))
            got = getattr(tstate, f).numpy()[0]
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, err_msg=f"t={t} {f}", **TOL)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"t={t} {f}")
        for f in ("track_id", "active", "det_index"):
            np.testing.assert_array_equal(
                getattr(tout, f).numpy()[0], np.asarray(getattr(jout, f)),
                err_msg=f"t={t} out.{f}")
        np.testing.assert_allclose(tout.boxes.numpy()[0], np.asarray(jout.boxes),
                                   **TOL)
    state = type(tstate)(*(x[0] for x in tstate))
    return state, type(tout)(*(x[0] for x in tout))


def test_full_width_250_objects_lossless():
    """250 rows on 512 slots: every object is born on frame 1 and stays
    matched, ids 1..250 once each, nothing dropped."""
    state, out = _run_both(num_dets_fed=250, track_slots=512)
    assert int(out.active.sum()) == 250
    assert int(state.dropped_births) == 0
    ids = np.sort(out.track_id[out.active].numpy())
    np.testing.assert_array_equal(ids, np.arange(1, 251))


def test_truncation_to_128_loses_objects():
    """The 128-row cut tracks 128 of the 250 objects."""
    _, out = _run_both(num_dets_fed=128, track_slots=512)
    assert int(out.active.sum()) == 128


def test_slot_overflow_counts_dropped_births():
    state, out = _run_both(num_dets_fed=250, track_slots=128, frames=1)
    assert int(out.active.sum()) == 128
    assert int(state.dropped_births) == 250 - 128


def test_pipeline_truncated_dets_counter():
    """The port's Pipeline counts the valid detections beyond
    tracker_max_dets exactly, cross-checked against predict() on the
    same frame, as the JAX test does."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import Pipeline

    det_cfg = DetectorConfig(weights="yolov8n", imgsz=160, conf=1e-8,
                             max_det=64, half=False)
    pipe = Pipeline(det_cfg, tracker="bytetrack.yaml", track_slots=32,
                    tracker_max_dets=8, device="cpu")
    frame, n_dets = None, 0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        cand = rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)
        n = len(pipe.predict(cand).boxes)
        if n > n_dets:
            frame, n_dets = cand, n
        if n_dets > 8:
            break
    if n_dets <= 8:
        pytest.skip("random-weight detector produced too few dets")
    pipe.track(frame)
    assert int(pipe.track_state.truncated_dets[0]) == n_dets - 8
    pipe.track(frame)
    assert int(pipe.track_state.truncated_dets[0]) == 2 * (n_dets - 8)
