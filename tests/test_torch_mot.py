"""The port's MOT data and tools against the JAX package's:
data/mot.py (``MotSequence``, ``load_mot_txt``, ``save_mot_results``,
``track_sequence_public``), tools/eval_mot.py (the public protocol),
tools/make_mot_fixture.py and media/video.OcclusionRelayClip.

On the committed fixture tests/fixtures/MOT-synth01 the port's
``eval_mot --public --device cpu`` prints the JAX tool's JSON lines,
character for character, at BASELINE.md's numbers; the tracks of
``track_sequence_public`` carry the JAX tracks' ids, boxes within 1e-4
px (float32 Kalman algebra in another order).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.data import mot as jmot
from strongsort_yolo_tpu.media.video import OcclusionRelayClip as JaxRelayClip
from strongsort_yolo_tpu.tools import eval_mot as jeval
from strongsort_yolo_tpu.tools import make_mot_fixture as jfixture
from strongsort_yolo_tpu_torch.data import mot as tmot
from strongsort_yolo_tpu_torch.media.video import OcclusionRelayClip
from strongsort_yolo_tpu_torch.tools import eval_mot as teval
from strongsort_yolo_tpu_torch.tools import make_mot_fixture as tfixture
from test_mot import mini_seq  # noqa: F401  (a fixture)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "MOT-synth01")

# BASELINE.md:148-152 (mota, idf1, fp, fn, idsw)
BASELINE = {
    "bytetrack.yaml": (0.9155, 0.9264, 0, 165, 1),
    "botsort.yaml": (0.9155, 0.9264, 0, 165, 1),
    "strongsort.yaml": (0.9089, 0.9233, 1, 177, 1),
    "bytetrack.yaml --strongsort-pp": (0.9913, 0.9612, 2, 14, 1),
    "bytetrack.yaml --strongsort-pp --aflink": (0.9913, 0.9612, 2, 14, 1),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("which", ["fixture", "mini"])
def test_mot_sequence_equals_jax(which, mini_seq):  # noqa: F811
    path = FIXTURE if which == "fixture" else mini_seq
    want, got = jmot.MotSequence(path), tmot.MotSequence(path)
    for attr in ("name", "fps", "width", "height", "img_dir", "ext",
                 "seq_length", "frame_files"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert len(got) == len(want) == (300 if which == "fixture" else 25)
    for kw in ({}, {"person_only": False}, {"min_vis": 0.5}):
        assert got.ground_truth(**kw) == want.ground_truth(**kw)
    for conf in (0.0, 0.5):
        assert got.public_detections(conf) == want.public_detections(conf)


def test_frames_read_through_cv2(mini_seq):  # noqa: F811
    import cv2

    seq = tmot.MotSequence(mini_seq)
    frames = list(seq.frames())
    assert len(frames) == 25
    for path, frame in zip(seq.frame_files, frames):
        assert np.array_equal(frame, cv2.imread(path))


def test_frames_name_missing_cv2(mini_seq, monkeypatch):  # noqa: F811
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        next(tmot.MotSequence(mini_seq).frames())


def test_save_results_round_trip(mini_seq, tmp_path):  # noqa: F811
    seq = tmot.MotSequence(mini_seq)
    gt = seq.ground_truth()
    hyp = [[(tid, x1 + 0.123, y1, x2, y2 - 0.456) for tid, x1, y1, x2, y2 in
            rows] for rows in gt]
    got, want = str(tmp_path / "port" / "res.txt"), str(tmp_path / "res.txt")
    tmot.save_mot_results(got, hyp)
    jmot.save_mot_results(want, hyp)
    with open(got) as a, open(want) as b:
        assert a.read() == b.read()
    back = tmot.load_mot_txt(got, len(gt), person_only=False)
    assert back == jmot.load_mot_txt(want, len(gt), person_only=False)
    assert len(back[0]) == len(gt[0])
    m = tmot.evaluate_sequence(seq, back)
    assert m == jmot.evaluate_sequence(jmot.MotSequence(mini_seq), back)
    assert m["mota"] == 1.0


def jax_public_step(tracker: str):
    """The JAX tool's public-protocol step and state for ``tracker``."""
    from strongsort_yolo_tpu.config import load_tracker_config
    from strongsort_yolo_tpu.track.bytetrack import bytetrack_step
    from strongsort_yolo_tpu.track.state import init_track_state
    from strongsort_yolo_tpu.track.strongsort import strongsort_step

    tcfg = load_tracker_config(tracker)
    if tracker == "strongsort.yaml":
        tcfg = dataclasses.replace(tcfg, lambda_appearance=0.0,
                                   max_cosine_distance=1.0)

        def step(st, b, s, c, v):
            feats = jnp.zeros((b.shape[0], 512), jnp.float32)
            return strongsort_step(st, b, s, c, v, feats, tcfg)

        return jax.jit(step), init_track_state(128, feat_dim=512)
    return (jax.jit(lambda st, b, s, c, v: bytetrack_step(st, b, s, c, v,
                                                          tcfg)),
            init_track_state(128))


@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "strongsort.yaml"])
def test_track_sequence_public_equals_jax(tracker):
    want = jmot.track_sequence_public(jmot.MotSequence(FIXTURE),
                                      *jax_public_step(tracker))
    step, state = teval.public_tracker(tracker, "cpu")
    assert state.track_id.shape == (1, 128)
    got = tmot.track_sequence_public(tmot.MotSequence(FIXTURE), step, state)
    assert len(got) == len(want) == 300
    assert sum(map(len, got)) > 1500
    for t, (g, w) in enumerate(zip(got, want)):
        assert [r[0] for r in g] == [r[0] for r in w], t
        if g:
            assert np.allclose(np.array([r[1:] for r in g]),
                               np.array([r[1:] for r in w]), rtol=0,
                               atol=1e-4), t


def run_tool(main, argv, capsys) -> list[dict]:
    assert main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("config", sorted(BASELINE))
def test_eval_mot_public_equals_jax(config, capsys, mini_seq,  # noqa: F811
                                    tmp_path):
    """bytetrack.yaml also runs the mini sequence as a second sequence,
    for the OVERALL line, and writes the results files (``--out``)."""
    tracker, *flags = config.split()
    seqs = [FIXTURE, mini_seq] if config == "bytetrack.yaml" else [FIXTURE]
    argv = seqs + ["--public", "--tracker", tracker] + flags
    out = {}
    if len(seqs) > 1:
        out = {k: ["--out", str(tmp_path / k)] for k in ("jax", "port")}
    want = run_tool(jeval.main, argv + out.get("jax", []), capsys)
    got = run_tool(teval.main, argv + ["--device", "cpu"] + out.get("port", []),
                   capsys)
    assert json.dumps(got) == json.dumps(want)
    m = got[0]
    assert m["seq"] == "MOT-synth01"
    assert (round(m["mota"], 4), round(m["idf1"], 4), m["fp"], m["fn"],
            m["idsw"]) == BASELINE[config]
    assert len(got) == (3 if len(seqs) > 1 else 1)
    for name in ("MOT-synth01.txt", "MINI-01.txt") if out else ():
        with open(tmp_path / "jax" / name) as a, \
                open(tmp_path / "port" / name) as b:
            assert a.read() == b.read(), name


def test_make_mot_fixture_reproduces_the_fixture(tmp_path, capsys):
    out = str(tmp_path / "MOT-synth01")
    assert tfixture.main([out, "--seed", "7"]) == 0
    for name in ("seqinfo.ini", "gt/gt.txt", "det/det.txt"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(FIXTURE, name), "rb") as b:
            assert a.read() == b.read(), name
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    assert tfixture.make_tracks(50, 5, rng_a) == jfixture.make_tracks(50, 5,
                                                                      rng_b)


@pytest.mark.parametrize("pan", [0.0, 10.0])
def test_occlusion_relay_clip_equals_jax(pan):
    want, got = JaxRelayClip(cycles=1, pan_amp=pan), OcclusionRelayClip(
        cycles=1, pan_amp=pan)
    assert (got.num_frames, got.h, got.w) == (want.num_frames, want.h,
                                              want.w) == (190, 320, 320)
    n = 0
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), t
        for hidden in (False, True):
            assert got.truth(t, include_hidden=hidden) == want.truth(
                t, include_hidden=hidden)
        n += 1
    assert n == 190
    assert got.pan(37) == want.pan(37) != ((0, 0) if pan else None)
