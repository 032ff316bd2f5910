"""The port's app (``strongsort_yolo_tpu_torch.app.run``) and CLI against
the JAX app on the same frames and the same weights: the trained
``assets/yolov8n_synth160.npz`` detector on ``SyntheticDetSource`` frames,
imgsz 160, float32 (``half=False``) on both sides, the port on the CPU.

Bars: the label files parsed, frame, class and id exact, confidence
within 0.001, coordinates within 1 px (``int()`` truncates them, so a
float32 difference of 1e-5 can move one field by a pixel); equal
``StreamStats`` frames, counts and line counts; the same event kinds.
Also the port against itself: batched label files byte-identical to a
sequential run, kill and resume equal to the uninterrupted run (within
a loop and across the two loops), the count hint, stream-failure
isolation, ``botsort.yaml``'s host GMC equal to the JAX app's, the int8
app's calibration in both loops, no silent CPU, the CLI writing the files ``run`` writes, and
runs that share one pipeline (``make_pipeline``).

One JAX app run per configuration, shared through module-scoped
fixtures.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.app import AppConfig as JAppConfig
from strongsort_yolo_tpu.app import run as jrun
from strongsort_yolo_tpu.media.video import SyntheticDetSource as JSynthDet
from strongsort_yolo_tpu.track import gmc_tpu
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu.track.strongsort import StrongSortConfig as JStrongSortConfig
from strongsort_yolo_tpu_torch import app as tapp
from strongsort_yolo_tpu_torch import cli as tcli
from strongsort_yolo_tpu_torch.app import AppConfig, run
from strongsort_yolo_tpu_torch.media.video import SyntheticDetSource
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig
from test_torch_flow_pipeline import panned_clip

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
BASE = dict(track=True, weights=CKPT, imgsz=160, max_det=16, half=False,
            tracker="bytetrack.yaml")
LINE_X = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ArraySource:
    """Frames of an array as a source (``w``, ``h``, iteration); each frame
    a copy, since the app draws into the frames it is given."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.h, self.w = frames.shape[1:3]

    def __iter__(self):
        for f in self.frames:
            yield f.copy()


def _det_sources(mod, lengths, sizes=None, seed0=0):
    sizes = sizes or [(320, 320)] * len(lengths)
    return [mod(num_frames=n, size=hw, num_objects=3, seed=seed0 + s)
            for s, (n, hw) in enumerate(zip(lengths, sizes))]


def _both(tmp_path_factory, label, jsources, tsources, **kw):
    """The JAX app and the port's app on the same sources -> (JAX stats,
    port stats); kw is AppConfig's, the port's with device="cpu"."""
    out = tmp_path_factory.mktemp(label)
    jkw = dict(kw)
    tkw = dict(kw)
    for side, d in (("jax", jkw), ("port", tkw)):
        d["output_dir"] = str(out / side)
        if d.get("log_events"):
            d["log_events"] = str(out / side / "events.jsonl")
    if isinstance(jkw.get("tracker"), tuple):
        jkw["tracker"], tkw["tracker"] = kw["tracker"]
    jst = jrun(JAppConfig(**jkw), sources=jsources)
    tst = run(AppConfig(device="cpu", **tkw), sources=tsources)
    return jst, tst


def _parse(path):
    with open(path) as f:
        return [line.split() for line in f]


def assert_labels_close(want_path, got_path) -> int:
    """Label files parsed: same rows, frame/class/id exact, conf within
    0.001, coordinates within 1 px -> the number of fields that differ."""
    want, got = _parse(want_path), _parse(got_path)
    assert len(got) == len(want), (want_path, len(want), len(got))
    differ = 0
    for a, b in zip(want, got):
        assert len(b) == len(a) == 12
        assert b[:3] == a[:3], (a, b)
        assert abs(float(b[3]) - float(a[3])) <= 1e-3 + 1e-9, (a, b)
        differ += b[3] != a[3]
        for i in range(4, 8):
            assert abs(int(b[i]) - int(a[i])) <= 1, (a, b)
            differ += b[i] != a[i]
        assert b[8:] == a[8:] == ["-1"] * 4
    return differ


def assert_stats_match(jstats, tstats):
    assert len(tstats) == len(jstats)
    differ = rows = 0
    for a, b in zip(jstats, tstats):
        assert b.failed is None and a.failed is None, (a.failed, b.failed)
        assert b.errors == a.errors == 0
        assert b.frames == a.frames
        assert b.counts == a.counts
        assert b.line_counts == a.line_counts
        assert (b.dropped_births, b.truncated_dets) == (
            a.dropped_births, a.truncated_dets)
        if a.labels_file:
            differ += assert_labels_close(a.labels_file, b.labels_file)
            rows += len(_parse(b.labels_file))
            assert os.path.getsize(b.output_video) > 0
    assert rows > 0  # the trained detector finds and tracks the objects
    print(f"label rows {rows}, fields differing from JAX {differ}")
    return differ


def _kinds(path):
    with open(path) as f:
        return [json.loads(line)["event"] for line in f]


def _text(path):
    with open(path) as f:
        return f.read()


# -- against the JAX app ----------------------------------------------------


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    """One stream of 40 frames, ByteTrack, counts, the count line of
    tests/test_counting_line.py, events, a checkpoint every 10 frames."""
    kw = dict(BASE, count=True, count_line=(LINE_X, 0.0, LINE_X, 320.0),
              log_events=True, checkpoint_every=10)
    return _both(tmp_path_factory, "seq", _det_sources(JSynthDet, [40]),
                 _det_sources(SyntheticDetSource, [40]), **kw)


def test_sequential_matches_jax(sequential):
    jst, tst = sequential
    assert tst[0].frames == 40
    assert assert_stats_match(jst, tst) == 0


def test_line_counts_match_jax_and_truth(sequential):
    """The directed line is crossed twice by the truth centroids
    (tests/test_counting_line.py:87); both apps count both."""
    jst, tst = sequential
    src = SyntheticDetSource(num_frames=40, size=(320, 320), num_objects=3,
                             seed=0)
    prev, crossings = {}, 0
    for t in range(40):
        for tid, x1, _, x2, _ in src.truth(t):
            cx = (x1 + x2) / 2
            if tid in prev and (prev[tid] - LINE_X) * (cx - LINE_X) < 0:
                crossings += 1
            prev[tid] = cx
    assert crossings == 2
    got = tst[0].line_counts
    assert got == jst[0].line_counts
    assert sum(got["in"].values()) + sum(got["out"].values()) == crossings
    assert tst[0].counts == jst[0].counts and tst[0].counts


def test_events_and_checkpoints_match_jax(sequential, tmp_path_factory):
    jst, tst = sequential
    jdir = os.path.dirname(jst[0].labels_file)
    tdir = os.path.dirname(tst[0].labels_file)
    kinds = _kinds(os.path.join(tdir, "events.jsonl"))
    assert kinds == _kinds(os.path.join(jdir, "events.jsonl"))
    assert kinds == ["stream_start"] + ["checkpoint"] * 4 + ["stream_end"]
    assert os.path.isfile(os.path.join(tdir, "synthetic_ckpt", "state.pt"))
    st = tst[0].stage_times
    for stage in ("decode", "dispatch", "infer_track", "analytics", "draw",
                  "encode"):
        assert st[stage]["count"] >= 40, (stage, st)


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    """Three streams of uneven lengths (4, 6, 5) batched, as
    tests/test_multisource.py:71 runs the JAX app; and the port
    sequentially."""
    lengths = [4, 6, 5]
    kw = dict(BASE, count=True)
    jst, tst = _both(tmp_path_factory, "bat",
                     _det_sources(JSynthDet, lengths),
                     _det_sources(SyntheticDetSource, lengths), **kw)
    seq = run(AppConfig(device="cpu", multi_mode="sequential",
                        output_dir=str(tmp_path_factory.mktemp("bat_seq")),
                        **kw),
              sources=_det_sources(SyntheticDetSource, lengths))
    return jst, tst, seq, lengths


def test_batched_uneven_lengths_match_jax(batched):
    jst, tst, _, lengths = batched
    assert [s.frames for s in tst] == lengths
    assert assert_stats_match(jst, tst) == 0
    for s in tst:  # the batched loop's per-tick stages; one more read
        # than ticks, the one that finds every stream at its end
        counts = {k: v["count"] for k, v in s.stage_times.items()}
        assert counts["decode"] == max(lengths) + 1, counts
        for stage in ("stack", "dispatch", "infer_track"):
            assert counts[stage] == max(lengths), counts


def test_batched_equals_sequential_byte_for_byte(batched):
    _, tst, seq, lengths = batched
    for b, s, n in zip(tst, seq, lengths):
        assert b.frames == s.frames == n
        assert b.failed is None and b.errors == 0
        assert _text(b.labels_file) == _text(s.labels_file)
        assert b.counts == s.counts


def test_mixed_resolutions_match_jax(tmp_path_factory):
    sizes = [(320, 320), (256, 320), (320, 320)]
    jst, tst = _both(tmp_path_factory, "mixed",
                     _det_sources(JSynthDet, [4] * 3, sizes),
                     _det_sources(SyntheticDetSource, [4] * 3, sizes),
                     **BASE)
    assert [s.frames for s in tst] == [4, 4, 4]
    assert len({s.labels_file for s in tst}) == 3
    assert assert_stats_match(jst, tst) == 0


def test_flow_tpu_config_object_matches_jax(tmp_path_factory):
    """BoT-SORT with gmc_method="flow_tpu" given as a config object on
    both sides, two panned streams batched; the JAX estimate runs the
    Pallas LK kernel in interpret mode."""
    frames = [panned_clip(6, seed=s) for s in (1, 2)]
    kw = dict(BASE, tracker=(
        JByteTrackConfig(tracker_type="botsort", gmc_method="flow_tpu"),
        ByteTrackConfig(tracker_type="botsort", gmc_method="flow_tpu")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gmc_tpu, "estimate_warp", functools.partial(
            gmc_tpu.estimate_warp, method="pallas_interpret"))
        jst, tst = _both(tmp_path_factory, "flow",
                         [ArraySource(f) for f in frames],
                         [ArraySource(f) for f in frames], **kw)
    assert [s.frames for s in tst] == [6, 6]
    assert assert_stats_match(jst, tst) == 0


def test_strongsort_with_trained_osnet_matches_jax(tmp_path_factory):
    """StrongSORT (GMC off on both sides) with the trained OSNet .npz, two
    streams batched."""
    kw = dict(BASE, count=True, reid_weights=OSNET,
              tracker=(JStrongSortConfig(gmc_method="none"),
                       StrongSortConfig(gmc_method="none")))
    jst, tst = _both(tmp_path_factory, "ss",
                     _det_sources(JSynthDet, [6, 6], seed0=3),
                     _det_sources(SyntheticDetSource, [6, 6], seed0=3),
                     **kw)
    assert assert_stats_match(jst, tst) == 0


# -- the port's own semantics -------------------------------------------------


def _srcs(lengths=(6, 6)):
    return _det_sources(SyntheticDetSource, list(lengths))


@pytest.mark.parametrize("mode", ["sequential", "batched", "across"])
def test_kill_and_resume_equals_uninterrupted(tmp_path, mode):
    """A run stopped after frame 3 (a checkpoint every frame) and resumed
    gives the uninterrupted run's label files: within the sequential
    loop, within the batched loop, and stopped in a sequential run,
    resumed in a batched one (one checkpoint format for both), as
    tests/test_app_e2e.py:152-228 holds the JAX app."""
    kill_mode = "sequential" if mode != "batched" else "batched"
    resume_mode = "batched" if mode != "sequential" else "sequential"
    full = run(AppConfig(device="cpu", output_dir=str(tmp_path / "full"),
                         multi_mode=resume_mode, **BASE), sources=_srcs())
    out = str(tmp_path / "resumed")
    first = run(AppConfig(device="cpu", output_dir=out, max_frames=3,
                          checkpoint_every=1, multi_mode=kill_mode, **BASE),
                sources=_srcs())
    assert [s.frames for s in first] == [3, 3]
    events = str(tmp_path / "events.jsonl")
    resumed = run(AppConfig(device="cpu", output_dir=out, resume=True,
                            multi_mode=resume_mode, log_events=events,
                            **BASE), sources=_srcs())
    for f, r in zip(full, resumed):
        assert r.frames == 6
        assert _text(r.labels_file) == _text(f.labels_file)
        assert len(_parse(r.labels_file)) > 0
    with open(events) as fh:
        resume_ev = [json.loads(line) for line in fh]
    resume_ev = [e for e in resume_ev if e["event"] == "resume"]
    assert [e["frame_id"] for e in resume_ev] == [3, 3]


def test_count_without_track_prints_hint(capsys):
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import Pipeline

    cfg = AppConfig(track=False, count=True, imgsz=160, half=False,
                    save=False, device="cpu")
    pipe = Pipeline(DetectorConfig(weights=CKPT, imgsz=160, half=False,
                                   max_det=16), device="cpu",
                    tracker="bytetrack.yaml")
    stats = tapp.process_video(cfg, _srcs([2])[0], "s", pipe)
    assert stats.frames == 0
    assert "count works only when objects are tracking" in capsys.readouterr().out


def test_stream_failure_isolation(tmp_path, capsys):
    """A file that does not open gets the reference's message and empty
    stats; the next stream runs (tests/test_aux.py:118)."""
    cfg = AppConfig(device="cpu", weights=CKPT, imgsz=160, half=False,
                    max_det=16, save=False, max_frames=2,
                    tracker="bytetrack.yaml")
    stats = run(cfg, sources=[str(tmp_path / "missing.mp4"), _srcs([2])[0]])
    assert stats[0].frames == 0 and stats[0].failed is None
    assert stats[1].frames == 2
    assert "Error: Could not open video file" in capsys.readouterr().out


def test_predict_mode_draws_and_writes_no_labels(tmp_path):
    stats = run(AppConfig(device="cpu", weights=CKPT, imgsz=160, half=False,
                          max_det=16, output_dir=str(tmp_path)),
                sources=_srcs([3]))
    assert stats[0].frames == 3
    assert _text(stats[0].labels_file) == ""
    assert os.path.getsize(stats[0].output_video) > 0


def test_botsort_yaml_runs_as_flow_tpu(tmp_path_factory, capsys):
    """Before the host estimators were ported, the app ran botsort.yaml's
    sparseOptFlow as flow_tpu. Now botsort.yaml runs sparseOptFlow on the
    host, as the JAX app does: on a panned clip the label files equal the
    JAX app's byte for byte, with no [INFO] line; a flow_tpu config object
    still runs flow_tpu (other labels on the same clip)."""
    frames = panned_clip(6, seed=3, pan=(12, -6))
    kw = dict(BASE, count=True, tracker="botsort.yaml")
    jst, tst = _both(tmp_path_factory, "botsort_host", [ArraySource(frames)],
                     [ArraySource(frames)], **kw)
    assert "[INFO]" not in capsys.readouterr().out
    assert _text(tst[0].labels_file) == _text(jst[0].labels_file)
    assert len(_parse(tst[0].labels_file)) > 0
    flow = ByteTrackConfig(tracker_type="botsort", gmc_method="flow_tpu")
    out = tmp_path_factory.mktemp("botsort_flow")
    fst = run(AppConfig(device="cpu", output_dir=str(out),
                        **dict(kw, tracker=flow)), sources=[ArraySource(frames)])
    assert _text(fst[0].labels_file) != _text(tst[0].labels_file)


def test_int8_is_refused_before_any_stream(tmp_path, monkeypatch):
    """int8 where the pipeline cannot take it (a segment model, an unknown
    mode) is refused before any stream opens, by the pipeline's checks;
    the int8 app itself is test_int8_app_calibrates_once_per_loop."""
    opened = []
    monkeypatch.setattr(tapp, "open_source", lambda s: opened.append(s))
    with pytest.raises(ValueError, match="segment"):
        run(AppConfig(device="cpu", quant="int8",
                      **dict(BASE, weights="yolov8n-seg")), sources=_srcs([2]))
    with pytest.raises(ValueError, match="unknown quant mode"):
        run(AppConfig(device="cpu", quant="int4", **BASE), sources=_srcs([2]))
    assert opened == []


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_int8_app_calibrates_once_per_loop(tmp_path, monkeypatch, capsys,
                                           mode):
    """quant="int8": the per-stream loop calibrates on its stream's first
    frame, the batched loop on tick 0's first two live frames and then
    refreshes its steps, each printing the JAX app's calibration line;
    afterwards every int8 conv holds its static scale."""
    from strongsort_yolo_tpu_torch.models.common import int8_convs
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline

    refreshed = []
    orig = BatchedPipeline.refresh_steps
    monkeypatch.setattr(BatchedPipeline, "refresh_steps",
                        lambda self: (refreshed.append(1), orig(self)))
    cfg = AppConfig(device="cpu", quant="int8", multi_mode=mode,
                    output_dir=str(tmp_path), **BASE)
    pipe = tapp.make_pipeline(cfg)
    n = 1 if mode == "batched" else 2
    stats = run(cfg, sources=_srcs([4, 4]), pipeline=pipe)
    out = capsys.readouterr().out
    assert out.count("[INFO] int8: calibrated 32 convs") == n
    assert len(refreshed) == (mode == "batched")
    assert [st.frames for st in stats] == [4, 4]
    assert all(len(_parse(st.labels_file)) > 0 for st in stats)
    assert all(c.xscale is not None for c in int8_convs(pipe.model))


def test_app_without_device_raises_on_a_cpu_only_machine(monkeypatch):
    """No silent CPU: AppConfig() leaves the device to the pipeline, which
    wants CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert AppConfig().device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(AppConfig(save=False, **BASE), sources=_srcs([2]))


def test_media_checks_fail_before_the_first_frame(monkeypatch):
    """show without cv2, and save with neither the native encoder nor
    cv2, fail at the start of run, not inside the loop."""
    opened = []
    monkeypatch.setattr(tapp, "open_source", lambda s: opened.append(s))
    monkeypatch.setattr(tapp, "_has_cv2", lambda: False)
    with pytest.raises(RuntimeError, match="cv2"):
        run(AppConfig(device="cpu", show=True, save=False, **BASE),
            sources=_srcs([2]))
    monkeypatch.setattr(tapp, "encoder_available", lambda: False)
    with pytest.raises(RuntimeError, match="encoder"):
        run(AppConfig(device="cpu", **BASE), sources=_srcs([2]))
    assert opened == []


def test_cli_writes_what_run_writes(tmp_path):
    """cli.main on a video file (written by the port's native encoder, or
    cv2) against run on the same file: the same label files and stats."""
    from strongsort_yolo_tpu_torch.media.native_decoder import (
        NativeVideoWriter,
        encoder_available,
    )
    from strongsort_yolo_tpu_torch.media.video import VideoWriter

    path = str(tmp_path / "clip.mp4")
    writer = (NativeVideoWriter if encoder_available() else VideoWriter)(
        path, 320, 320, 15.0)
    for f in SyntheticDetSource(num_frames=6, size=(320, 320), seed=4):
        writer.write(f)
    writer.release()
    args = ["--source", path, "--track", "--count", "--weights", CKPT,
            "--imgsz", "160", "--max-det", "16", "--no-half", "--tracker",
            "bytetrack.yaml", "--device", "cpu", "--output",
            str(tmp_path / "cli"), "--log-events",
            str(tmp_path / "cli" / "events.jsonl")]
    assert tcli.main(args) == 0
    want = run(AppConfig(sources=(path,), count=True,
                         output_dir=str(tmp_path / "run"),
                         log_events=str(tmp_path / "run" / "events.jsonl"),
                         device="cpu", **BASE))
    got_labels = str(tmp_path / "cli" / "clip_labels.txt")
    assert _text(got_labels) == _text(want[0].labels_file)
    assert len(_parse(got_labels)) > 0
    assert os.path.getsize(str(tmp_path / "cli" / "clip_output.mp4")) > 0
    assert _kinds(str(tmp_path / "cli" / "events.jsonl")) == _kinds(
        str(tmp_path / "run" / "events.jsonl"))
    assert tcli._parse_line("1,2,3.5,4") == (1.0, 2.0, 3.5, 4.0)


def test_runs_share_one_pipeline(tmp_path):
    """run on a pipeline from make_pipeline, shared by several runs: each
    run equals one that builds its own pipeline, label files byte for
    byte, whichever loop ran on the pipeline before (flow_tpu, whose
    previous frames must not leak from one run into the next)."""
    kw = dict(BASE, tracker=ByteTrackConfig(tracker_type="botsort",
                                            gmc_method="flow_tpu"))

    def cfg(tag, mode):
        return AppConfig(count=True, device="cpu", multi_mode=mode,
                         output_dir=str(tmp_path / tag), **kw)

    pipe = tapp.make_pipeline(cfg("unused", "batched"))
    for i, mode in enumerate(("sequential", "batched", "sequential")):
        shared = run(cfg(f"shared{i}", mode), sources=_srcs([4, 5]),
                     pipeline=pipe)
        own = run(cfg(f"own{i}", mode), sources=_srcs([4, 5]))
        for a, b in zip(own, shared):
            assert (b.frames, b.counts) == (a.frames, a.counts)
            assert _text(b.labels_file) == _text(a.labels_file)
            assert len(_parse(b.labels_file)) > 0
