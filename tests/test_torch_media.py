"""The port's media and utility copies against the JAX package's modules on
the same inputs: the synthetic sources, the label writer, the counters,
the trajectory memory, the stage timers, the event log, the cv2 and
native annotators (pixels), the libav decoder and encoder bindings; and
the port's own pieces: the checkpoint (torch.save of one stream's state,
resumed into a row of a batch), the media probe, the loaders' error
text, and what the media layer does without cv2.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.media import annotator as jannotator
from strongsort_yolo_tpu.media import native as jnative
from strongsort_yolo_tpu.media import native_decoder as jnd
from strongsort_yolo_tpu.media import video as jvideo
from strongsort_yolo_tpu.pipeline import Boxes as JBoxes
from strongsort_yolo_tpu.pipeline import Results as JResults
from strongsort_yolo_tpu.utils import counting as jcounting
from strongsort_yolo_tpu.utils.labels import LabelWriter as JLabelWriter
from strongsort_yolo_tpu.utils.logging import EventLogger as JEventLogger
from strongsort_yolo_tpu.utils.profiling import StageTimers as JStageTimers
from strongsort_yolo_tpu.utils.trajectories import TrajectoryMemory as JTrajectoryMemory
from strongsort_yolo_tpu_torch import media
from strongsort_yolo_tpu_torch.media import annotator, native, native_decoder, video
from strongsort_yolo_tpu_torch.pipeline import Boxes, Results
from strongsort_yolo_tpu_torch.track.state import TrackState, init_track_state
from strongsort_yolo_tpu_torch.utils import counting
from strongsort_yolo_tpu_torch.utils.checkpoint import restore_state, save_state
from strongsort_yolo_tpu_torch.utils.fps import FpsMeter
from strongsort_yolo_tpu_torch.utils.labels import LabelWriter
from strongsort_yolo_tpu_torch.utils.logging import EventLogger
from strongsort_yolo_tpu_torch.utils.profiling import StageTimers, trace
from strongsort_yolo_tpu_torch.utils.trajectories import TrajectoryMemory

NAMES = {0: "person", 1: "car", 2: "bus"}


def _track_frames(seed=0, n=12):
    """Per frame (xyxy, conf, cls, id) of a few tracks that move across
    x = 100, some leaving, one changing class."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n):
        ids = [i for i in (1, 2, 3, 4) if not (i == 3 and 4 <= t < 7)]
        xyxy = np.array([[60 + 9 * t + 7 * i, 20 * i, 90 + 9 * t + 7 * i,
                          20 * i + 40] for i in ids], np.float32)
        xyxy += rng.uniform(0, 0.9, xyxy.shape).astype(np.float32)
        conf = rng.uniform(0.3, 0.99, len(ids)).astype(np.float32)
        cls = np.array([(i + (t > 6 and i == 2)) % 3 for i in ids], np.float32)
        frames.append((xyxy, conf, cls, np.array(ids, np.float32)))
    return frames


@pytest.mark.parametrize("kind", ["SyntheticSource", "SyntheticDetSource"])
def test_synthetic_sources_equal_jax(kind):
    for kw in (dict(num_frames=7, size=(240, 320), seed=3),
               dict(num_frames=5, size=(320, 320), num_objects=2, seed=1)):
        a = getattr(jvideo, kind)(**kw)
        b = getattr(video, kind)(**kw)
        assert (b.w, b.h, b.fps) == (a.w, a.h, a.fps)
        for fa, fb in zip(a, b, strict=True):
            np.testing.assert_array_equal(fb, fa)
        for t in range(kw["num_frames"]):
            assert b.truth(t) == a.truth(t)


@pytest.mark.parametrize("compat", [False, True])
def test_label_writer_equals_jax(tmp_path, compat):
    """Both modes, and append on resume, byte for byte (coordinates
    truncated by int(), conf rounded to 3 places)."""
    frames = _track_frames()
    for cls, name in ((JLabelWriter, "jax"), (LabelWriter, "port")):
        path = str(tmp_path / name / "labels.txt")
        for lo, hi, append in ((0, 6, False), (6, 12, True)):
            with cls(path, compat=compat, append=append) as w:
                for t in range(lo, hi):
                    boxes = (JBoxes if name == "jax" else Boxes)(*frames[t])
                    w.write_frame(t + 1, boxes)
                w.write_frame(99, Boxes(np.zeros((0, 4)), [], []))  # no ids
    with open(tmp_path / "jax" / "labels.txt") as f:
        want = f.read()
    with open(tmp_path / "port" / "labels.txt") as f:
        got = f.read()
    assert got == want and len(got.splitlines()) == 45
    assert got.split()[0] == ("0" if compat else "1")


def test_counters_and_trails_equal_jax():
    frames = _track_frames(seed=2, n=20)
    line = (100.0, 0.0, 100.0, 200.0)
    j_count, t_count = jcounting.StreamingCounter(NAMES), counting.StreamingCounter(NAMES)
    j_line = jcounting.LineCrossCounter(NAMES, line)
    t_line = counting.LineCrossCounter(NAMES, line)
    j_tr, t_tr = JTrajectoryMemory(), TrajectoryMemory()
    for f in frames:
        for c, tr, lc, B in ((j_count, j_tr, j_line, JBoxes),
                             (t_count, t_tr, t_line, Boxes)):
            c.update(B(*f))
            tr.update(B(*f))
            lc.update(B(*f))
        assert t_count.counts() == j_count.counts()
        assert t_line.counts() == j_line.counts()
        assert t_line.totals() == j_line.totals()
        assert {k: list(v) for k, v in t_tr.items()} == {
            k: list(v) for k, v in j_tr.items()}
    assert sum(t_line.totals()) > 0 and t_count.counts()
    for _ in range(400):
        j_line.update(JBoxes(np.zeros((0, 4)), [], [], id=[]))
        t_line.update(Boxes(np.zeros((0, 4)), [], [], id=[]))
    j_line.prune(300)
    t_line.prune(300)
    assert t_line._prev == j_line._prev == {}


def test_stage_timers_event_logger_fps(tmp_path, monkeypatch):
    """StageTimers' summary from the same clock readings, the event log's
    lines with the same time stamp, equal to the JAX modules'."""
    import time

    ticks = iter(np.arange(0, 100, 0.0125).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    timers = []
    for cls in (JStageTimers, StageTimers):
        t = cls()
        for name in ("decode", "dispatch", "decode", "draw"):
            with t.stage(name):
                pass
        timers.append(t)
    assert timers[1].summary() == timers[0].summary()
    assert timers[1].report() == timers[0].report()
    for cls, name in ((JEventLogger, "jax"), (EventLogger, "port")):
        log = cls(str(tmp_path / name / "events.jsonl"))
        log.log("stream_start", stream="a", start_frame=0)
        log.log("stream_end", stream="a", counts={"car": 2}, frames=np.int64(3))
        log.close()
    lines = [open(tmp_path / n / "events.jsonl").read() for n in ("jax", "port")]
    assert lines[1] == lines[0]
    assert [json.loads(x)["event"] for x in lines[1].splitlines()] == [
        "stream_start", "stream_end"]
    fps = FpsMeter(window=2)
    assert fps.tick() == "" and fps.tick().startswith("FPS: ")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).add_(1)
    assert prof.key_averages() is not None
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def _draw(mod, kind, frame, f, trails_frames, counts, line):
    """One frame drawn by an annotator of module ``mod``: results with
    boxes and ids, trails, the counts overlay, the count line, fps."""
    B, R = (JBoxes, JResults) if mod is jannotator else (Boxes, Results)
    tr = (JTrajectoryMemory if mod is jannotator else TrajectoryMemory)()
    for g in trails_frames:
        tr.update(B(*g))
    ann = getattr(mod, kind)(NAMES, seed=0)
    out = ann.draw_results(frame.copy(), R(B(*f), NAMES))
    ann.draw_trails(out, tr)
    out = ann.draw_counts(out, counts)
    ann.draw_count_line(out, line, (2, 1))
    ann.draw_fps(out, "FPS: 31.25")
    return out


@pytest.mark.parametrize("kind", ["Annotator", "NativeAnnotator"])
def test_annotators_draw_the_jax_pixels(kind):
    if kind == "NativeAnnotator" and not (native.available()
                                          and jnative.available()):
        pytest.skip(f"drawing shim unavailable: {native.build_error}")
    frames = _track_frames(seed=4)
    frame = np.random.default_rng(0).integers(0, 255, (240, 320, 3), np.uint8)
    counts = {"car": 3, "person": 2}
    line = (100.0, 0.0, 100.0, 200.0)
    want = _draw(jannotator, kind, frame, frames[5], frames[:6], counts, line)
    got = _draw(annotator, kind, frame, frames[5], frames[:6], counts, line)
    assert (got != frame).any()
    np.testing.assert_array_equal(got, want)


def test_make_annotator_picks_cv2_then_native(monkeypatch):
    assert isinstance(annotator.make_annotator(NAMES), annotator.Annotator)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    if native.available():
        assert isinstance(annotator.make_annotator(NAMES),
                          annotator.NativeAnnotator)


def test_native_shim_builds_into_build_not_native():
    if not native.available():
        pytest.skip(f"drawing shim unavailable: {native.build_error}")
    path = native.lib_path()
    assert os.path.isfile(path)
    assert os.sep + os.path.join("build", "media") + os.sep in path
    assert os.path.dirname(path) != native_decoder.NATIVE_DIR


def test_checkpoint_round_trip_into_a_batch_row(tmp_path):
    """One stream's (1, ...) state saved and restored on the CPU, then
    copied into row 1 of a batch of 3, as the batched app resumes a
    stream; a checkpoint of another shape is refused."""
    gen = torch.Generator().manual_seed(0)
    one = init_track_state(1, 16, feat_dim=8)
    one = TrackState(*(
        (torch.rand(f.shape, generator=gen) * 50).to(f.dtype) for f in one))
    save_state(str(tmp_path / "s_ckpt"), one, 17)
    assert os.listdir(tmp_path / "s_ckpt") == ["state.pt"]
    template = init_track_state(1, 16, feat_dim=8)
    got, frame = restore_state(str(tmp_path / "s_ckpt"), template)
    assert frame == 17
    for a, b in zip(one, got):
        assert b.dtype == a.dtype and torch.equal(b, a)
    batch = init_track_state(3, 16, feat_dim=8)
    fresh = init_track_state(3, 16, feat_dim=8)
    for batched, row in zip(batch, got):
        batched[1:2].copy_(row)
    for b, f, a in zip(batch, fresh, one):
        assert torch.equal(b[1], a[0])
        assert torch.equal(b[0], f[0]) and torch.equal(b[2], f[2])
    with pytest.raises(ValueError, match="feat"):
        restore_state(str(tmp_path / "s_ckpt"),
                      init_track_state(1, 16, feat_dim=4))
    with pytest.raises(ValueError, match="one stream"):
        save_state(str(tmp_path / "b_ckpt"), batch, 3)


def _clip(path, writer_cls):
    src = jvideo.SyntheticSource(num_frames=9, size=(240, 320),
                                 num_objects=3, seed=2)
    w = writer_cls(path, 320, 240, 15.0)
    assert w.ok
    for f in src:
        w.write(f)
    w.release()


@pytest.mark.skipif(not (native_decoder.available()
                         and native_decoder.encoder_available()),
                    reason="the libav shims do not load here: "
                    f"{native_decoder.decoder_error()} / "
                    f"{native_decoder.encoder_error()}")
def test_decoder_and_encoder_bindings_equal_jax(tmp_path):
    """A clip written by each package's encoder binding decodes to the
    same frames through each package's decoder binding (the same
    libraries, as tests/test_native_decoder.py holds the JAX ones)."""
    paths = {}
    for name, cls in (("jax", jnd.NativeVideoWriter),
                      ("port", native_decoder.NativeVideoWriter)):
        paths[name] = str(tmp_path / f"{name}.mp4")
        _clip(paths[name], cls)
    decoded = {}
    for wname, path in paths.items():
        for rname, cls in (("jax", jnd.NativeVideoReader),
                           ("port", native_decoder.NativeVideoReader)):
            r = cls(path)
            assert r.ok and (r.width, r.height) == (320, 240)
            assert r.fps == pytest.approx(15.0)
            decoded[wname, rname] = np.stack(list(r))
            r.release()
    want = decoded["jax", "jax"]
    assert want.shape == (9, 240, 320, 3)
    for key, frames in decoded.items():
        np.testing.assert_array_equal(frames, want, err_msg=str(key))
    bad = native_decoder.NativeVideoReader(str(tmp_path / "missing.mp4"))
    assert not bad.ok and list(bad) == []


def test_media_status_and_load_errors(tmp_path, monkeypatch):
    """The probe reports each piece; a library that does not load keeps
    the loader's OSError text, which names it, and its reader reports
    ok == False."""
    status = media.media_status()
    assert set(status) == {"cv2", "shim", "decoder", "encoder"}
    bogus = tmp_path / "libvideo_decoder.so"
    bogus.write_bytes(b"not an ELF file")
    monkeypatch.setattr(native_decoder, "DECODER_PATH", str(bogus))
    monkeypatch.setattr(native_decoder, "_loaded", {})
    err = native_decoder.decoder_error()
    assert err is not None and str(bogus) in err
    assert not native_decoder.available()
    assert not native_decoder.NativeVideoReader(str(bogus)).ok
    assert media.media_status()["decoder"] == err
    monkeypatch.setattr(native_decoder, "ENCODER_PATH",
                        str(tmp_path / "libvideo_encoder.so"))
    assert "no such file" in native_decoder.encoder_error()
    assert not native_decoder.NativeVideoWriter(
        str(tmp_path / "o.mp4"), 32, 32).ok


def test_without_cv2(monkeypatch, tmp_path, capsys):
    """cv2's reader and writer raise an ImportError that names the native
    route; a file that neither the native decoder nor cv2 opens gets the
    reference's message."""
    from strongsort_yolo_tpu_torch import app

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="native"):
        video.VideoReader("0")
    with pytest.raises(ImportError, match="NativeVideoWriter"):
        video.VideoWriter(str(tmp_path / "a.mp4"), 32, 32)
    assert not app._has_cv2()
    bogus = tmp_path / "clip.mp4"
    bogus.write_bytes(b"no video here")
    assert app.open_source(str(bogus)) == (None, 0, 0)
    assert "Error: Could not open video file" in capsys.readouterr().out
