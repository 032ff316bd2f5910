"""Tracking quality of the port against the bars the JAX package holds
itself to (BASELINE.md): the ByteTrack public-detection baseline on the
committed MOT-synth01 fixture, the trained synth160 checkpoint end to
end on rendered video, and StrongSORT with the trained OSNet through the
occlusion bounce, and again through a panning camera with the device
camera-motion compensation (``gmc_method="flow_tpu"``), and through the
occlusion relay with and without appearance and with the StrongSORT++
pass (the port's ``tools/eval_sequence.run_arm`` and ``eval_pp``). Same
bars as tests/test_mot_baseline.py, tests/test_trained_e2e.py,
tests/test_reid_quality.py and tests/test_sequence_quality.py; the
panning bar comes from the JAX package's ``tools/eval_sequence.run_arm``
on the same clip. The port's data, media and metrics modules used here
are held to the JAX package's in tests/test_torch_mot.py and
tests/test_torch_postprocess.py.
"""

import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu_torch.config import DetectorConfig, load_tracker_config
from strongsort_yolo_tpu_torch.data.mot import MotSequence, evaluate_sequence
from strongsort_yolo_tpu_torch.media.video import (
    BounceClip,
    OcclusionRelayClip,
    SyntheticDetSource,
)
from strongsort_yolo_tpu_torch.pipeline import Pipeline
from strongsort_yolo_tpu_torch.tools.eval_sequence import eval_pp, run_arm
from strongsort_yolo_tpu_torch.track.bytetrack import bytetrack_step
from strongsort_yolo_tpu_torch.track.state import init_track_state
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig
from strongsort_yolo_tpu_torch.utils.metrics import track_clip

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "MOT-synth01")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bytetrack_public_baseline():
    seq = MotSequence(FIXTURE)
    cfg = load_tracker_config("bytetrack.yaml")
    n = 128
    state = init_track_state(1, 128)
    hyp = []
    for frame_dets in seq.public_detections(0.1):
        boxes = torch.zeros(1, n, 4)
        scores = torch.zeros(1, n)
        valid = torch.zeros(1, n, dtype=torch.bool)
        for i, d in enumerate(frame_dets[:n]):
            boxes[0, i] = torch.tensor(d[:4])
            scores[0, i] = min(max(d[4], 0.0), 1.0)
            valid[0, i] = True
        state, out = bytetrack_step(
            state, boxes, scores, torch.zeros(1, n, dtype=torch.int32), valid,
            cfg,
        )
        rows = torch.nonzero(out.active[0]).flatten().tolist()
        hyp.append([(int(out.track_id[0, i]), *out.boxes[0, i].tolist())
                    for i in rows])
    m = evaluate_sequence(seq, hyp)
    # the JAX tracker measured MOTA 0.9155, IDF1 0.9264, idsw 1
    assert m["mota"] >= 0.895, m
    assert m["idf1"] >= 0.905, m
    assert m["idsw"] <= 3, m


def test_trained_model_tracks_real_signal():
    pipe = Pipeline(
        DetectorConfig(weights=CKPT, imgsz=160, conf=0.3, iou=0.4,
                       max_det=16, half=False),
        tracker="bytetrack.yaml", track_slots=16, tracker_max_dets=16,
        device="cpu",
    )
    src = SyntheticDetSource(num_frames=30, size=(320, 320), num_objects=3,
                             seed=1)
    m = track_clip(pipe, src)
    assert m["mota"] > 0.8, m
    assert m["idf1"] > 0.8, m
    assert m["idsw"] == 0, m
    pred = pipe.predict(np.asarray(next(iter(src))))
    assert len(pred) >= 3 and set(pred.boxes.cls.astype(int)) <= {0, 1, 2}


def test_reid_recovery_with_trained_embedder():
    """Two objects hide behind a wall, bounce while hidden and re-emerge;
    motion alone swaps their ids, the trained OSNet must keep them (the
    JAX package measures idf1 0.697 and 4 id switches motion-only)."""
    pipe = Pipeline(
        DetectorConfig(weights=CKPT, imgsz=160, conf=0.3, iou=0.4,
                       max_det=16, half=False),
        tracker=StrongSortConfig(gmc_method="none", max_age=60),
        track_slots=16, tracker_max_dets=16, reid_weights=OSNET,
        device="cpu",
    )
    m = track_clip(pipe, BounceClip())
    assert m["idf1"] > 0.73, m
    assert m["idsw"] <= 3, m


def test_panning_relay_with_flow_gmc():
    """One occlusion-relay cycle per pair (190 frames, 320x320) under a
    Lissajous camera pan of amplitude 10 px, StrongSORT + trained OSNet
    with the device LK estimate of camera motion. The JAX package's
    ``run_arm(OcclusionRelayClip(cycles=1, pan_amp=10), lam=0.98,
    gmc=...)`` on the CPU measured, visible-only protocol: flow_tpu MOTA
    0.7261, IDF1 0.6328, 7 id switches; gmc none MOTA 0.7070, IDF1
    0.6125, 7 id switches. The port measured the flow_tpu numbers."""
    pipe = Pipeline(
        DetectorConfig(weights=CKPT, imgsz=160, conf=0.3, iou=0.4,
                       max_det=16, half=False),
        tracker=StrongSortConfig(gmc_method="flow_tpu", max_age=60,
                                 lambda_appearance=0.98),
        track_slots=16, tracker_max_dets=16, reid_weights=OSNET,
        device="cpu",
    )
    m = track_clip(pipe, OcclusionRelayClip(cycles=1, pan_amp=10))
    # between the JAX package's gmc-none and flow_tpu numbers: the bar
    # holds only with the camera motion compensated
    assert m["mota"] >= 0.715, m
    assert m["idf1"] >= 0.62, m
    assert m["idsw"] <= 7, m


@pytest.fixture(scope="module")
def relay_arms():
    """StrongSORT + trained OSNet over one occlusion-relay cycle per pair,
    through the port's ``tools/eval_sequence.run_arm`` (Pipeline.track),
    with appearance (lambda 0.98) and without (lambda 0, the cosine gate
    open), and each arm's StrongSORT++ pass (``eval_pp``: the learned
    AFLink linker and GSI) on its records: the arms of the JAX package's
    tests/test_sequence_quality.py, visible-only protocol."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, lam in (("reid", 0.98), ("lambda0", 0.0)):
            m, records, (gt_vis, gt_occ, _hyp) = run_arm(
                OcclusionRelayClip(cycles=1), lam=lam, device="cpu")
            out[name] = m["vis"]
            out[name + "_pp"] = eval_pp(records, (gt_vis, gt_occ),
                                        device="cpu")["vis"]
    finally:
        torch.set_num_threads(n_threads)
    return out


def test_appearance_reduces_id_switches(relay_arms):
    assert relay_arms["reid"]["idsw"] < relay_arms["lambda0"]["idsw"], relay_arms


def test_appearance_earns_idf1(relay_arms):
    assert (relay_arms["reid"]["idf1"]
            > relay_arms["lambda0"]["idf1"] + 0.01), relay_arms


def test_absolute_quality_floor(relay_arms):
    m = relay_arms["reid"]
    assert m["mota"] > 0.6, m
    assert m["idf1"] > 0.65, m


def test_strongsort_pp_cuts_switches(relay_arms):
    """The AFLink + GSI row of tests/test_sequence_quality.py: the offline
    pass on the appearance arm's records cuts id switches without costing
    IDF1."""
    assert relay_arms["reid_pp"]["idsw"] <= relay_arms["reid"]["idsw"], relay_arms
    assert (relay_arms["reid_pp"]["idf1"]
            >= relay_arms["reid"]["idf1"] - 0.02), relay_arms
