"""The port's YOLOv5 (classic anchor head and the ``u`` DFL head) against
the JAX package: the forward against a jitted ``yolov5_apply``, unfused
and fused, on JAX-initialised weights converted with params_from_jax, at
rtol = atol = 1e-4 (float32; XLA and PyTorch sum each convolution in
another order); then ``Pipeline.track`` and ``BatchedPipeline.step``
under ByteTrack and StrongSORT + the trained OSNet-x0_25 against the JAX
Pipeline on the same frames and weights, half=False on both sides: equal
row counts, track ids and classes, boxes within 1e-3 px and confidences
within 1e-5.

A random network's head outputs are nearly constant, so every anchor
would score alike: the pipeline cases first calibrate the head on one
frame (``chip_smoke.calibrate_head``: output rows scaled to a spread,
objectness or class biases shifted so that about 24 anchors clear conf),
on the port's model, and give both packages the calibrated tree.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.media.video import SyntheticDetSource
from strongsort_yolo_tpu.models import yolo as jyolo
from strongsort_yolo_tpu.models import yolov5 as jv5
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu.track.bytetrack import ByteTrackConfig as JByteTrackConfig
from strongsort_yolo_tpu.track.strongsort import StrongSortConfig as JStrongSortConfig
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.models import porting as tporting
from strongsort_yolo_tpu_torch.models import yolov5 as tv5
from strongsort_yolo_tpu_torch.models.yolo import build_model, fuse_model
from strongsort_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
TOL = dict(rtol=1e-4, atol=1e-4)
IMGSZ, CONF, TARGET = 160, 0.3, 24
# the scores' spread only, and a third of chip_smoke's: the gain that takes
# a random head's outputs (std 1e-4 to 2e-2) there magnifies the float32
# differences of the features (each conv summed in another order) alike,
# through wh = (2 sig)^2 * anchor past the 1e-3 px bar with scaled box
# rows, and past the 1e-5 confidence bar at v7's gain at 1.5
SPREAD = {"obj": 0.5, "cls": 0.5}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["yolov5n", "yolov5nu"])
def test_forward_vs_jax(name, fuse):
    cfg = jv5.build_v5(name)
    params = jv5.init_yolov5(jax.random.PRNGKey(1), cfg)
    x = np.random.default_rng(2).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(
        np.float32)
    tcfg = tv5.build_v5(name)
    model = tporting.model_from_state_dict(
        tporting.params_from_jax(jax.device_get(params), tcfg), tcfg)
    models = [model]
    if fuse:  # the port's fuse, and the JAX-fused tree converted
        params = jyolo.fuse_model(params)
        models = [fuse_model(model), tporting.model_from_state_dict(
            tporting.params_from_jax(jax.device_get(params), tcfg), tcfg)]
        assert all(m.fused for m in models)
    want = jax.jit(lambda p, x: jv5.yolov5_apply(p, x, cfg))(
        params, jnp.asarray(x))
    for model in models:
        with torch.no_grad():
            got = model.eval()(_nchw(x))
        assert set(got) == set(want) == (
            {"box_logits", "cls_logits"} if cfg.anchor_free
            else {"boxes", "scores"})
        for key in want:
            assert got[key].dtype == torch.float32
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       **TOL)


def test_build_v5_names():
    assert build_model("yolov5n") == tv5.Yolov5Config(scale="n")
    assert build_model("yolov5su.pt") == tv5.Yolov5Config(
        scale="s", anchor_free=True)
    for name in ("yolov5n", "yolov5s", "yolov5mu", "yolov5xu"):
        want = jv5.build_v5(name)
        got = tv5.build_v5(name)
        assert (got.scale, got.anchor_free, got.nc) == (
            want.scale, want.anchor_free, want.nc)
    with pytest.raises(ValueError, match="scale"):
        tv5.build_v5("yolov5q")


@pytest.mark.parametrize("name", ["yolov5s", "yolov5su"])
def test_parameter_count_equals_jax(name):
    tree = jax.eval_shape(
        lambda k: jv5.init_yolov5(k, jv5.build_v5(name)), jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    model = tv5.Yolov5Model(tv5.build_v5(name))
    # the JAX tree's leaves hold the BN statistics too: the state_dict's
    assert sum(v.numel() for v in model.state_dict().values()) == want


def _set_leaf(tree, key: str, value: np.ndarray) -> None:
    *path, leaf = key.split(".")
    node = tree
    for p in path:
        node = node[int(p)] if isinstance(node, list) else node[p]
    node[leaf] = value


def calibrated_tree(tree, cfg, frame, target=TARGET):
    """``tree`` with its head calibrated on ``frame`` through the port's
    float32 model (chip_smoke.calibrate_head), the head's leaves written
    back in the JAX layout."""
    model = tporting.model_from_state_dict(
        tporting.params_from_jax(tree, cfg), cfg).eval()
    lp = letterbox_params(*frame.shape[:2], IMGSZ)
    img = letterbox(torch.from_numpy(frame[None]), lp, dtype=torch.float32)
    chip_smoke.calibrate_head(model, img, CONF, target, SPREAD)
    out = copy.deepcopy(tree)
    for key, value in model.state_dict().items():
        if key.startswith("detect."):
            arr = value.numpy()
            _set_leaf(out, key, arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr)
    return out


def video(s, t):
    """(S, T, 320, 320, 3): moving shaded rectangles, 3 or 4 per stream."""
    srcs = [SyntheticDetSource(num_frames=t, size=(320, 320),
                               num_objects=3 + i % 2, seed=i + 1)
            for i in range(s)]
    return np.stack([np.stack(list(src)) for src in srcs])


def assert_same(want, got, t):
    for s, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b), f"t={t} s={s}: {len(a)} != {len(b)}"
        np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3,
                                   err_msg=f"t={t} s={s}")
        np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
        np.testing.assert_array_equal(b.boxes.cls, a.boxes.cls)
        np.testing.assert_allclose(b.boxes.conf, a.boxes.conf, atol=1e-5)


def pipelines(name, tree, tracker):
    """The JAX and the port Pipeline on the same weights, imgsz 160, f32."""
    det = dict(weights=name, imgsz=IMGSZ, conf=CONF, iou=0.4, max_det=16,
               half=False)
    sizes = dict(track_slots=16, tracker_max_dets=16, reid_topk=16)
    if tracker == "strongsort":
        jt, tt = (JStrongSortConfig(gmc_method="none"),
                  StrongSortConfig(gmc_method="none"))
        sizes["reid_weights"] = OSNET
    else:
        jt = JByteTrackConfig(tracker_type="bytetrack", gmc_method="none")
        tt = ByteTrackConfig(tracker_type="bytetrack", gmc_method="none")
    jpipe = JPipeline(JDetectorConfig(**det), tracker=jt, params=tree, **sizes)
    tpipe = Pipeline(DetectorConfig(**det), tracker=tt, device="cpu",
                     params=tporting.params_from_jax(tree, build_model(name)),
                     **sizes)
    return jpipe, tpipe


def run_track_and_step(name, tree, tracker, *, s=2, t=5):
    """Pipeline.track over stream 0, then BatchedPipeline.step over all
    S streams, each against the JAX Pipeline; -> track rows seen."""
    frames = video(s, t)
    tree = calibrated_tree(tree, build_model(name), frames[0, 0])
    jpipe, tpipe = pipelines(name, tree, tracker)
    rows = 0
    for i in range(t):
        got = tpipe.track(frames[0, i])
        assert_same([jpipe.track(frames[0, i])], [got], i)
        rows += len(got)
    jb = jpipe.track_batch_prepare(s, frames.shape[2:4])
    tb = BatchedPipeline(tpipe, s, frames.shape[2:4])
    for i in range(t):
        got = tb.step(frames[:, i])
        assert_same(jb.step(frames[:, i]), got, i)
        rows += sum(len(r) for r in got)
    return rows


@pytest.mark.parametrize("tracker", ["bytetrack", "strongsort"])
@pytest.mark.parametrize("name", ["yolov5n", "yolov5nu"])
def test_pipeline_vs_jax(name, tracker):
    """Each head under each tracker, through track and step."""
    tree = jax.device_get(jv5.init_yolov5(jax.random.PRNGKey(3),
                                          jv5.build_v5(name)))
    rows = run_track_and_step(name, tree, tracker)
    assert rows >= 20  # the tracker holds tracks: a test of ids, not of empties


@pytest.mark.parametrize("name", ["yolov5s", "yolov5su", "yolov7"])
def test_v5_v7_default_device_and_no_conv_kernel(monkeypatch, name):
    """No card: the pipeline raises, naming device='cpu', and does not drop
    to the CPU; K7's route, held for v8/v11 only, is refused."""
    with pytest.raises(ValueError, match="conv_kernel"):
        Pipeline(DetectorConfig(weights=name, imgsz=160), device="cpu",
                 tracker="bytetrack.yaml", conv_kernel=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(DetectorConfig(weights=name, imgsz=160), tracker="bytetrack.yaml")


def test_track_chunk_and_async_match_track():
    """yolov5n (calibrated) with StrongSORT + the trained OSNet:
    track_async / materialize give what T track calls give, exactly;
    Pipeline.track_chunk over the T frames their ids, and boxes within
    1e-4 px (its detect runs one batch of T, whose convolutions the CPU
    sums in another order; tests/test_torch_flow_pipeline.py's bar)."""
    frames = video(1, 5)[0]
    name = "yolov5n"
    tree = calibrated_tree(jax.device_get(jv5.init_yolov5(
        jax.random.PRNGKey(3), jv5.build_v5(name))), build_model(name), frames[0])
    pipes = [pipelines(name, tree, "strongsort")[1] for _ in range(3)]
    want = [pipes[0].track(f) for f in frames]
    chunk = pipes[1].track_chunk(frames)
    handles = [pipes[2].track_async(f) for f in frames]
    got_async = [pipes[2].materialize(h) for h in handles]
    assert sum(len(r) for r in want) > 0
    for t, (a, b, c) in enumerate(zip(want, got_async, chunk)):
        np.testing.assert_array_equal(b.boxes.xyxy, a.boxes.xyxy, err_msg=f"t={t}")
        np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
        np.testing.assert_array_equal(b.boxes.conf, a.boxes.conf)
        np.testing.assert_array_equal(c.boxes.id, a.boxes.id)
        np.testing.assert_allclose(c.boxes.xyxy, a.boxes.xyxy, atol=1e-4,
                                   err_msg=f"t={t}")
