"""The port's asynchronous API against its synchronous one and against the
JAX package's, on the CPU.

- ``Pipeline.track_async`` / ``materialize`` in the app's overlapped
  order (dispatch frame t, then materialize frame t - 1) equals the
  port's ``track`` exactly and the JAX ``track_async`` / ``materialize``
  on the same frames and explicit warps.
- ``BatchedPipeline.step_async`` N times, then ``materialize`` newest
  first (the first handle twice), equals N ``step`` calls exactly and
  the JAX ``track_batch_prepare(...).step_async`` / ``materialize`` for
  ByteTrack, BoT-SORT with host warps, StrongSORT at cadence 2 (JAX with
  ``auto_topk=True``), ``flow_tpu`` (JAX through its Pallas LK in
  interpret mode) and the pose and segment extras.
- ``reset_stream`` and ``sync`` between pending handles, a dp=2 mesh of
  the CPU equal to the unsharded batch and refusing ``reid_cadence`` 2,
  ``auto_topk`` changing nothing.

Against JAX: equal rows and ids, boxes and keypoints within 1e-3 px,
masks within 1e-5 and equal polygons (``test_torch_tasks.
assert_same_results``, the bars of the other pipeline tests), float32 on
both sides (half=False), imgsz 160, S=2.
"""

import functools
import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.media.video import SyntheticDetSource
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track import gmc_tpu
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu.track.strongsort import StrongSortConfig as JStrongSortConfig
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.parallel.mesh import make_mesh
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig
from test_auto_topk import _frames
from test_torch_flow_pipeline import panned_clip
from test_torch_task_pipeline import render
from test_torch_tasks import assert_same_results

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
CKPT = os.path.join(ASSETS, "yolov8n_synth160.npz")
OSNET = os.path.join(ASSETS, "osnet_x0_25_synth.npz")
T = 5
PANS = ((4, -3), (-3, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pan_warps(pans) -> np.ndarray:
    """(len(pans), 2, 3) float32 translations by each stream's pan."""
    w = np.tile(np.eye(2, 3, dtype=np.float32), (len(pans), 1, 1))
    w[:, :, 2] = pans
    return w


def _case(name):
    """-> (port Pipeline kwargs, JAX Pipeline kwargs, JAX track_batch_prepare
    kwargs, frames (T, S, H, W, 3), warps (T, S, 2, 3) or None)."""
    det = dict(weights=CKPT, imgsz=160, conf=0.3, iou=0.4, max_det=16,
               half=False)
    sizes = dict(track_slots=16, tracker_max_dets=16)
    warps = None
    if name in ("bytetrack", "strongsort_cadence2"):
        if name == "bytetrack":
            port, jax_ = (ByteTrackConfig(tracker_type="bytetrack"),
                          JByteTrackConfig(tracker_type="bytetrack"))
            srcs = [SyntheticDetSource(num_frames=T, size=(320, 320),
                                       num_objects=3, seed=s + 1)
                    for s in range(2)]
            frames = np.stack([np.stack(list(src)) for src in srcs], 1)
        else:
            port, jax_ = (StrongSortConfig(gmc_method="none"),
                          JStrongSortConfig(gmc_method="none"))
            sizes.update(reid_topk=16, reid_weights=OSNET, reid_cadence=2)
            frames = np.stack([_frames(t, 4) for t in range(T)])
        return (dict(det=DetectorConfig(**det), tracker=port, **sizes),
                dict(det=JDetectorConfig(**det), tracker=jax_, **sizes),
                dict(auto_topk=name == "strongsort_cadence2"), frames, warps)
    if name in ("botsort_warps", "flow_tpu"):
        gmc = "sparseOptFlow" if name == "botsort_warps" else "flow_tpu"
        frames = np.stack([panned_clip(T, seed=s + 1, pan=p)
                           for s, p in enumerate(PANS)], 1)
        if gmc != "flow_tpu":
            warps = np.tile(_pan_warps(PANS), (T, 1, 1, 1))
        return (dict(det=DetectorConfig(**det), tracker=ByteTrackConfig(
                    tracker_type="botsort", gmc_method=gmc), **sizes),
                dict(det=JDetectorConfig(**det), tracker=JByteTrackConfig(
                    tracker_type="botsort", gmc_method=gmc), **sizes),
                {}, frames, warps)
    asset, task = {"pose": ("yolo11n_pose_synth160", "pose"),
                   "seg": ("yolov8n_seg_synth160", "segment")}[name]
    det = dict(det, weights=os.path.join(ASSETS, asset + ".npz"), max_det=8)
    sizes = dict(track_slots=8, tracker_max_dets=8)
    frames = render(task, seed=len(asset))[:, :T].swapaxes(0, 1)
    return (dict(det=DetectorConfig(**det),
                 tracker=ByteTrackConfig(gmc_method="none"), **sizes),
            dict(det=JDetectorConfig(**det),
                 tracker=JByteTrackConfig(gmc_method="none"), **sizes),
            {}, frames, warps)


def _port(kw) -> Pipeline:
    kw = dict(kw)
    return Pipeline(kw.pop("det"), device="cpu", **kw)


def _jax(kw) -> JPipeline:
    kw = dict(kw)
    return JPipeline(kw.pop("det"), **kw)


def assert_identical(want, got, what=""):
    """Equal rows, boxes, ids, scores, classes, keypoints and masks."""
    assert len(got) == len(want), what
    for name in ("xyxy", "conf", "cls", "id"):
        np.testing.assert_array_equal(getattr(got.boxes, name),
                                      getattr(want.boxes, name), err_msg=what)
    for name in ("keypoints", "masks"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), what
        if a is not None:
            np.testing.assert_array_equal(b.data, a.data, err_msg=what)


@pytest.fixture
def jax_pallas_lk(monkeypatch):
    """The JAX step's flow_tpu estimate through its Pallas LK kernel in
    interpret mode, the math of the port's K5 plain version."""
    monkeypatch.setattr(
        gmc_tpu, "estimate_warp",
        functools.partial(gmc_tpu.estimate_warp, method="pallas_interpret"),
    )


def test_track_async_overlapped_equals_track_and_jax():
    """One stream, BoT-SORT with host warps: dispatch t, materialize t - 1."""
    port_kw, jax_kw, _, frames, warps = _case("botsort_warps")
    frames, warps = frames[:, 0], warps[:, 0]
    sync = _port(port_kw)
    want = [sync.track(f, w) for f, w in zip(frames, warps)]
    pipe, jpipe = _port(port_kw), _jax(jax_kw)
    got, jgot, pending = [], [], None
    for f, w in zip(frames, warps):
        handle = (pipe.track_async(f, w), jpipe.track_async(f, w))
        if pending is not None:
            got.append(pipe.materialize(pending[0]))
            jgot.append(jpipe.materialize(pending[1]))
        pending = handle
    got.append(pipe.materialize(pending[0]))
    jgot.append(jpipe.materialize(pending[1]))
    assert sum(len(r) for r in got) >= 3 * (T - 2)
    for t, (a, b, j) in enumerate(zip(want, got, jgot)):
        assert_identical(a, b, f"t={t}")
        assert_same_results(j, b, f"jax t={t}")
        np.testing.assert_array_equal(b.orig_img, frames[t])


@pytest.mark.parametrize("name", ["bytetrack", "botsort_warps",
                                  "strongsort_cadence2", "flow_tpu", "pose",
                                  "seg"])
def test_step_async_queue_equals_step_and_jax(name, request):
    if name == "flow_tpu":
        request.getfixturevalue("jax_pallas_lk")
    port_kw, jax_kw, prep_kw, frames, warps = _case(name)
    s, hw = frames.shape[1], frames.shape[2:4]
    sync_pipe = _port(port_kw)
    sync = BatchedPipeline(sync_pipe, s, hw)
    want = [sync.step(frames[t], None if warps is None else warps[t])
            for t in range(T)]
    pipe = _port(port_kw)
    bp = pipe.track_batch_prepare(s, hw)
    jb = _jax(jax_kw).track_batch_prepare(s, hw, **prep_kw)
    handles = [(bp.step_async(frames[t], None if warps is None else warps[t]),
                jb.step_async(frames[t], None if warps is None else warps[t]))
               for t in range(T)]
    got, jgot = [None] * T, [None] * T
    for t in reversed(range(T)):  # newest first
        got[t] = bp.materialize(handles[t][0])
        jgot[t] = jb.materialize(handles[t][1])
    again = bp.materialize(handles[0][0])
    rows = 0
    for t in range(T):
        for i in range(s):
            what = f"{name} t={t} s={i}"
            assert_identical(want[t][i], got[t][i], what)
            assert_same_results(jgot[t][i], got[t][i], "jax " + what)
            rows += len(got[t][i])
    for a, b in zip(got[0], again):
        assert_identical(a, b, "materialized twice")
    assert rows >= 2 * (T - 3)  # the objects are tracked
    # the ReID trackers wait once per tick for the detection counts
    reid = name.startswith("strongsort")
    assert (pipe.count_waits, sync_pipe.count_waits) == (T * reid, T * reid)


def test_reset_stream_and_sync_between_pending_handles():
    """reset_stream and sync called while ticks are pending: the results
    of the synchronous sequence."""
    port_kw, _, _, frames, _ = _case("bytetrack")
    seq = BatchedPipeline(_port(port_kw), 2, (320, 320))
    want = []
    for t in range(T):
        if t == 3:
            seq.reset_stream(1)
        want.append(seq.step(frames[t]))
    bp = BatchedPipeline(_port(port_kw), 2, (320, 320))
    handles = []
    for t in range(T):
        if t == 3:
            bp.reset_stream(1)
            bp.sync()
        handles.append(bp.step_async(frames[t]))
    for t in reversed(range(T)):
        for i, (a, b) in enumerate(zip(want[t], bp.materialize(handles[t]))):
            assert_identical(a, b, f"t={t} s={i}")
    assert int(bp.states.frame_id[1]) == T - 3


def test_track_batch_prepare_mesh_and_auto_topk():
    """A mesh refuses reid_cadence > 1 (as the JAX package does); at
    cadence 1 the streams over a dp=2 mesh of the CPU step as the
    unsharded batch does (same rows and ids, boxes within 1e-3 px),
    handles materialized newest first."""
    port_kw, _, _, frames, _ = _case("strongsort_cadence2")
    pipe = _port(port_kw)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="reid_cadence"):
        pipe.track_batch_prepare(2, (320, 320), mesh=mesh)
    one = _port({**port_kw, "reid_cadence": 1})
    plain = one.track_batch_prepare(2, (320, 320))
    want = [plain.step(frames[t]) for t in range(3)]
    assert sum(len(r) for r in want[2]) > 0
    sharded = one.track_batch_prepare(2, (320, 320), mesh=mesh)
    handles = [sharded.step_async(frames[t]) for t in range(3)]
    for t in reversed(range(3)):
        for i, (a, b) in enumerate(zip(want[t], sharded.materialize(handles[t]))):
            # a block's forward has another batch size: the CPU's convs
            # may round the last bit otherwise
            assert len(a) == len(b), (t, i)
            np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
            np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3)
    runs = []
    for auto in (False, True):
        bp = pipe.track_batch_prepare(2, (320, 320), auto_topk=auto)
        runs.append([bp.step(frames[t]) for t in range(3)])
    for t, (a_t, b_t) in enumerate(zip(*runs)):
        for a, b in zip(a_t, b_t):
            assert_identical(a, b, f"t={t}")


def test_transfer_on_the_cpu():
    """utils/transfer on the CPU: no ring, nothing pinned, frames checked,
    the host's own tensors handed through."""
    from strongsort_yolo_tpu_torch.utils.transfer import (
        Copies, Download, to_device)

    copies = Copies(torch.device("cpu"))
    assert copies.ring((2, 8, 8, 3)) is None and copies.upload is None
    frames = np.arange(2 * 8 * 8 * 3, dtype=np.uint8).reshape(2, 8, 8, 3)
    with copies.frames(frames, None) as dev:
        assert dev.device.type == "cpu" and np.shares_memory(dev.numpy(), frames)
    for bad in (frames.astype(np.float32), frames[..., :2], frames[0]):
        with pytest.raises(ValueError, match="uint8 BGR"):
            with copies.frames(bad, None):
                pass
    down = Download(torch.arange(6))
    assert down.query() and down.done is None
    np.testing.assert_array_equal(down.wait(), np.arange(6))
    warps = np.eye(2, 3, dtype=np.float32)[None]
    np.testing.assert_array_equal(to_device(warps, torch.device("cpu")).numpy(),
                                  warps)
