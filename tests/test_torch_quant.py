"""The port's int8 post-training quantization (``ops/quant.py``, K8's plain
version ``ops/cuda/quant_kernel.conv_s8_plain``, ``Conv``'s int8 mode and
``models/common.quantize_model``,
``Pipeline(quant="int8")`` and ``calibrate_int8``) against the JAX
package's ``ops/quant.py`` and its int8 ``Pipeline``.

Bars:
- ``quantize_conv``: ``wq`` and ``wscale`` bit-identical.
- ``quantize_model``: the same set of conv paths as the JAX walk, for
  v8, v11, v5 and v7 at full width (no forward: the JAX tree comes from
  ``jax.eval_shape``).
- ``conv_s8_plain`` against the jitted ``conv_int8_apply``: the int8 codes
  equal; ``act=False`` outputs bit-identical (exact int32 sums, and the
  dequantize as one fused multiply-add on both sides); ``act=True`` within
  4 float32 ulps of max(1, |ref|) in float32 and one bf16 unit at 1.0 of
  max(1, |ref|) in bfloat16: XLA's CPU ``exp`` inside the sigmoid differs
  from PyTorch's in the last bit on ~0.4% of 10^6 normal inputs, and
  bfloat16 rounds that float32 result once.
- The int8 pipeline on the same int8 weights (``params_from_jax`` of the
  JAX pipeline's quantized tree): the float layers (stem, first stages)
  sum in another order than XLA's and the SiLU's ``exp`` differs in the
  last bit, and quantization turns such a last-bit difference into a
  whole code step where it lies on a rounding boundary. So per frame:
  the same detections (count, classes), boxes within 1 px and
  confidences within 0.03 (measured worst over 30 + 30 frames: 0.92 px,
  0.0235), and at least two thirds of the frames within 1e-3 px (24 and
  27 of 30 measured); the same calibrated count; ``xscale`` within 16
  float32 ulps (measured 9: an activation's amax moves with those
  last-bit differences; computing the dequantize unfused during
  calibration, as the JAX package's eager calibration does, changed
  nothing). Between JAX's own int8 and float pipelines the same frames
  differ by 0.1 to 17 px.
- The MOTA / IDF1 guard of ``tests/test_quant.py`` through the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.config import DetectorConfig as JDetectorConfig
from strongsort_yolo_tpu.media.video import SyntheticDetSource
from strongsort_yolo_tpu.models import yolo as jyolo
from strongsort_yolo_tpu.models import yolov5 as jv5
from strongsort_yolo_tpu.models import yolov7 as jv7
from strongsort_yolo_tpu.ops import quant as jquant
from strongsort_yolo_tpu.pipeline import Pipeline as JPipeline
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.models import common, porting
from strongsort_yolo_tpu_torch.models.yolo import build_model, detector_family
from strongsort_yolo_tpu_torch.ops import quant
from strongsort_yolo_tpu_torch.ops.cuda import quant_kernel as qk
from strongsort_yolo_tpu_torch.pipeline import Pipeline
from strongsort_yolo_tpu_torch.utils.metrics import evaluate_mot

CKPT = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "yolov8n_synth160.npz")
DET = dict(weights=CKPT, imgsz=160, conf=0.3, iou=0.4, max_det=16,
           half=False)
SIZES = dict(tracker="bytetrack.yaml", track_slots=16, tracker_max_dets=16)
F32_ULP = 2.0 ** -23
BF16_UNIT_AT_1 = 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(3, 3, 32, 64), (1, 1, 48, 16),
                                   (3, 3, 1, 128)])
def test_quantize_conv_equals_jax(shape):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.2, shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel takes the 1e-8 floor
    want = jquant.quantize_conv({"w": jnp.asarray(w), "b": jnp.zeros(shape[3])})
    wq, wscale = quant.quantize_conv(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    assert wq.dtype == torch.int8 and wscale.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(want["wq"]))
    np.testing.assert_array_equal(wscale.numpy(), np.asarray(want["wscale"]))


def _jax_int8_paths(name: str) -> tuple[set[str], int]:
    """The paths of the convs the JAX quantize_model quantizes in the
    fused full-width ``name`` (shapes only) and its count."""
    key = jax.random.PRNGKey(0)
    if name.startswith("yolov5"):
        cfg = jv5.build_v5(name)
        fused = lambda: jyolo.fuse_model(jv5.init_yolov5(key, cfg))  # noqa: E731
    elif name.startswith("yolov7"):
        cfg = jv7.Yolov7Config()
        fused = lambda: jv7.fuse_yolov7(jv7.init_yolov7(key, cfg))  # noqa: E731
    else:
        cfg = jyolo.build_model(name)
        fused = lambda: jyolo.fuse_model(jyolo.init_model(key, cfg))  # noqa: E731
    count = {}

    def quantized():
        tree, count["n"] = jquant.quantize_model(fused())
        return tree

    paths = set()

    def walk(node, path):
        if isinstance(node, dict):
            if "wq" in node:
                paths.add(path)
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")

    walk(jax.eval_shape(quantized), "")
    return paths, count["n"]


@pytest.mark.parametrize("name,n", [("yolov8n", 32), ("yolo11n-pose", 52),
                                    ("yolov5s", 42), ("yolov7", 85)])
def test_quantize_model_picks_the_jax_convs(name, n):
    want, n_jax = _jax_int8_paths(name)
    cfg = build_model(name)
    with torch.device("meta"):
        model = detector_family(cfg)[0](cfg, fused=True)
    got = {common.jax_path(p) for p, _ in common.quantizable(model)}
    assert n_jax == len(want) == n
    assert got == want


def _conv_case(k, stride, groups, dtype, seed):
    rng = np.random.default_rng(seed)
    c_in = 16
    c_out = c_in if groups == "dw" else 24
    g = c_in if groups == "dw" else 1
    x = rng.normal(0, 1.5, (2, 11, 13, c_in)).astype(np.float32)
    x[0, 0, 0, 0] = 6.0  # the tensor's amax, away from the others
    w = rng.normal(0, 0.3, (k, k, c_in // g, c_out)).astype(np.float32)
    p = jquant.quantize_conv({"w": jnp.asarray(w),
                              "b": jnp.asarray(rng.normal(0, 0.5, c_out)
                                               .astype(np.float32))})
    xj = jnp.asarray(x).astype(dtype)
    return xj, p, g


@pytest.mark.parametrize("scale", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("groups", [1, "dw"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_conv_s8_plain_equals_jax(k, stride, groups, act, dtype, scale):
    xj, p, g = _conv_case(k, stride, groups, getattr(jnp, dtype),
                          seed=k * 8 + stride * 4 + act * 2 + (groups == "dw"))
    if scale == "static":
        p = dict(p, xscale=jnp.float32(5.5 / 127.0))
    kw = dict(stride=stride, groups=g, act=act)
    want = np.asarray(jax.jit(lambda p, x: jquant.conv_int8_apply(p, x, **kw)
                              .astype(jnp.float32))(p, xj))

    def codes(p, x):
        xf = x.astype(jnp.float32)
        xs = (p["xscale"] if "xscale" in p
              else jnp.maximum(jnp.max(jnp.abs(xf)), 1e-6) / 127.0)
        return jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)

    want_codes = np.asarray(jax.jit(codes)(p, xj)).transpose(0, 3, 1, 2)
    tdtype = getattr(torch, dtype)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(tdtype)
    wq = torch.from_numpy(np.asarray(p["wq"]).transpose(3, 2, 0, 1).copy())
    ws = torch.from_numpy(np.asarray(p["wscale"]))
    b = torch.from_numpy(np.asarray(p["b"]))
    xs = (torch.tensor(np.float32(p["xscale"])) if "xscale" in p
          else quant.dynamic_scale(x))
    np.testing.assert_array_equal(qk.quantize_act(x, xs).numpy(), want_codes)
    got = qk.conv_s8(x, wq, ws, b, xs, stride=stride, pad=(k - 1) // 2,
                     groups=g, act=act)
    assert got.dtype == tdtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    if not act:
        np.testing.assert_array_equal(got, want)
    else:
        unit = F32_ULP * 4 if dtype == "float32" else BF16_UNIT_AT_1
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= unit, err.max()
    sums = qk.conv_s8(x, wq, ws, b, xs, stride=stride, pad=(k - 1) // 2,
                      groups=g, act=act, sums=True)
    # the int32 sums against an int64 sum of the JAX codes
    xq = want_codes.astype(np.int64)
    wq64 = wq.numpy().astype(np.int64)
    pad = (k - 1) // 2
    xp = np.pad(xq, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ho, wo = sums.shape[2:]
    exact = np.zeros(tuple(sums.shape), np.int64)
    cig = wq64.shape[1]
    for co in range(wq64.shape[0]):
        ci0 = (co // (wq64.shape[0] // g)) * cig
        for ky in range(k):
            for kx in range(k):
                patch = xp[:, ci0:ci0 + cig, ky:ky + stride * ho:stride,
                           kx:kx + stride * wo:stride]
                exact[:, co] += np.einsum("nchw,c->nhw", patch,
                                          wq64[co, :, ky, kx])
    np.testing.assert_array_equal(sums.numpy(), exact)


def test_conv_s8_refuses_other_groups():
    x = torch.zeros(1, 8, 4, 4)
    wq = torch.zeros(8, 4, 3, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="depthwise"):
        qk.conv_s8(x, wq, torch.ones(8), torch.zeros(8), torch.tensor(1.0),
                   pad=1, groups=2)


def _tree_xscales(tree) -> dict[str, np.float32]:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "xscale" in node:
                out[path] = np.float32(node["xscale"])
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")

    walk(tree, "")
    return out


@pytest.fixture(scope="module")
def int8_pipes():
    """The JAX int8 pipeline, the port's on its quantized tree, and the
    port's quantizing the float checkpoint itself."""
    jp = JPipeline(JDetectorConfig(**DET, quant="int8"), **SIZES)
    _, cfg, _ = porting.load_checkpoint(CKPT)
    tree = jax.device_get(jp.params)
    tp = Pipeline(DetectorConfig(**DET), params=porting.params_from_jax(
        tree, cfg), model_cfg=cfg, device="cpu", **SIZES)
    own = Pipeline(DetectorConfig(**DET, quant="int8"), device="cpu", **SIZES)
    frames = list(SyntheticDetSource(num_frames=16, size=(320, 320),
                                     num_objects=3, seed=1))
    return jp, tp, own, tree, frames


def _same_detections(jp, tp, frames):
    """-> per frame the largest |box| and |conf| difference; raises where
    the count or the classes differ."""
    errs = []
    for t, f in enumerate(frames):
        a, b = jp.predict(f), tp.predict(f)
        assert len(a) == len(b) and np.array_equal(a.boxes.cls, b.boxes.cls), t
        errs.append((float(np.abs(a.boxes.xyxy - b.boxes.xyxy).max(initial=0)),
                     float(np.abs(a.boxes.conf - b.boxes.conf).max(initial=0))))
    return np.asarray(errs)


def _assert_close(errs):
    assert errs[:, 0].max() <= 1.0 and errs[:, 1].max() <= 0.03, errs
    assert (errs[:, 0] <= 1e-3).sum() * 3 >= 2 * len(errs), errs


def test_int8_pipeline_equals_jax(int8_pipes):
    """Dynamic scales, then static ones after calibrating on one frame."""
    jp, tp, own, tree, frames = int8_pipes
    # the port quantizing the checkpoint itself: the JAX tree's leaves up
    # to the last bit of the BN fold (its rsqrt differs from XLA's there),
    # (2 ulps), which moves a code on a rounding boundary by one
    mine = porting.jax_params(own.model.state_dict())
    flat_j, flat_t = {}, {}
    porting._flatten(tree, "", flat_j)
    porting._flatten(mine, "", flat_t)
    assert set(flat_j) == set(flat_t)
    codes = moved = 0
    for key, want in flat_j.items():
        got, want = np.asarray(flat_t[key]), np.asarray(want)
        assert got.dtype == want.dtype, key
        if key.endswith(".wq"):
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1, key
            codes, moved = codes + diff.size, moved + int((diff > 0).sum())
        else:
            np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-9,
                                       err_msg=key)
    assert sum(k.endswith(".wq") for k in flat_j) == 32
    assert moved <= 1e-4 * codes, (moved, codes)

    _assert_close(_same_detections(jp, tp, frames[:8]))
    n = tp.calibrate_int8(frames[:1])
    assert n == jp.calibrate_int8(frames[:1]) == 32
    want = _tree_xscales(jax.device_get(jp.params))
    got = {common.jax_path(name): np.float32(float(m.xscale))
           for name, m in tp.model.named_modules() if getattr(m, "int8", 0)}
    assert set(got) == set(want) and len(got) == 32
    ulps = [abs(int(got[k].view(np.int32)) - int(want[k].view(np.int32)))
            for k in want]
    assert max(ulps) <= 16, ulps
    _assert_close(_same_detections(jp, tp, frames[8:]))
    # the calibrated tree goes across and back leaf for leaf
    back = porting.jax_params(porting.params_from_jax(
        jax.device_get(jp.params), tp.model_cfg))
    assert _tree_xscales(back) == want


def test_calibrate_int8_keeps_float32_scales():
    """The cast of the model to bfloat16 keeps wscale, b and xscale in
    float32, as the JAX package keeps them."""
    pipe = Pipeline(DetectorConfig(**dict(DET, half=True), quant="int8"),
                    device="cpu", **SIZES)
    frame = next(iter(SyntheticDetSource(num_frames=1, size=(320, 320),
                                         num_objects=3, seed=1)))
    assert pipe.calibrate_int8([frame]) == 32
    for conv in common.int8_convs(pipe.model):
        assert conv.wq.dtype == torch.int8
        for name in ("wscale", "b", "xscale"):
            assert getattr(conv, name).dtype == torch.float32, name
    assert len(pipe.predict(frame)) > 0


def _mot(quant_mode):
    pipe = Pipeline(DetectorConfig(**DET, quant=quant_mode), device="cpu",
                    **SIZES)
    src = SyntheticDetSource(num_frames=30, size=(320, 320), num_objects=3,
                             seed=1)
    gt, hyp = [], []
    for t, frame in enumerate(src):
        r = pipe.track(frame)
        gt.append([tuple(g) for g in src.truth(t)])
        hyp.append([(int(r.boxes.id[i]), *r.boxes.xyxy[i])
                    for i in range(len(r.boxes))])
    return evaluate_mot(gt, hyp)


def test_int8_mota_within_guard():
    """tests/test_quant.py's guard, through the port."""
    mf, mq = _mot(None), _mot("int8")
    assert mq["mota"] >= mf["mota"] - 0.01, (mf, mq)
    assert mq["idf1"] >= mf["idf1"] - 0.01, (mf, mq)


def test_int8_refusals():
    with pytest.raises(ValueError, match="fuse=True"):
        Pipeline(DetectorConfig(**DET, fuse=False, quant="int8"),
                 device="cpu", **SIZES)
    with pytest.raises(ValueError, match="unknown quant mode"):
        Pipeline(DetectorConfig(**DET, quant="int4"), device="cpu", **SIZES)
    with pytest.raises(ValueError, match="conv_kernel"):
        Pipeline(DetectorConfig(**DET, quant="int8"), conv_kernel=True,
                 device="cpu", **SIZES)
    with pytest.raises(ValueError, match="KeyError"):
        Pipeline(DetectorConfig(weights="yolov8n-seg", imgsz=64, half=False,
                                quant="int8"), device="cpu", **SIZES)


def test_jax_int8_segment_fails_with_keyerror():
    """What the port's refusal names: the JAX quantize_model takes the
    segment model's mask branches, out layers included, into int8, and
    its forward then fails (traced on shapes only)."""
    cfg = jyolo.build_model("yolov8n-seg")

    def forward():
        params = jyolo.fuse_model(jyolo.init_model(jax.random.PRNGKey(0), cfg))
        q, _ = jquant.quantize_model(params)
        return jyolo.model_apply(q, jnp.zeros((1, 64, 64, 3)), cfg)

    with pytest.raises(KeyError, match="'w'"):
        jax.eval_shape(forward)
