"""K7's plain version (``ops/cuda/conv_kernel.conv_act_plain``, what the
wrapper runs on CPU tensors) against the JAX ``conv_act`` in interpret
mode, its rule ``eligible`` against the JAX one, and the route
``Pipeline(conv_kernel=True)`` against the JAX model with the same convs
through ``conv_act(interpret=True)``.

Tolerances: float32 2e-5 (the JAX kernel test's own: only the summation
order differs); bfloat16 one bf16 unit at 1.0 of the output scaled by
max(1, |ref|) (both round the float32 result once; a different float32
sum can flip that rounding); gradients 1e-4; the routed model 1e-4, as
the port's other model tests.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.prof import conv_kernel as jck  # noqa: E402

from strongsort_yolo_tpu.models import common as jcommon  # noqa: E402
from strongsort_yolo_tpu.models import yolo as jyolo  # noqa: E402
from strongsort_yolo_tpu_torch.config import DetectorConfig  # noqa: E402
from strongsort_yolo_tpu_torch.models import common as tcommon  # noqa: E402
from strongsort_yolo_tpu_torch.models import porting as tporting  # noqa: E402
from strongsort_yolo_tpu_torch.models import yolo as tyolo  # noqa: E402
from strongsort_yolo_tpu_torch.ops.cuda import conv_kernel as tck  # noqa: E402
from strongsort_yolo_tpu_torch.pipeline import Pipeline  # noqa: E402

CKPT = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "yolov8n_synth160.npz")
# the shape classes of tests/test_pallas_conv.py: (h, w, c_in, c_out, k)
CASES = [
    (40, 40, 32, 32, 3),
    (40, 40, 64, 80, 3),
    (40, 40, 80, 80, 3),
    (40, 40, 96, 64, 1),
    (40, 40, 192, 64, 1),
    (8, 200, 64, 64, 3),
]
BF16_ULP_AT_1 = 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n, h, w, c_in, c_out, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, h, w, c_in)).astype(np.float32)
    wt = (rng.normal(0, 1, (k * k * c_in, c_out))
          * np.sqrt(2.0 / (k * k * c_in))).astype(np.float32)
    b = rng.normal(0, 0.3, c_out).astype(np.float32)
    return x, wt, b


def _jax(x, wt, b, k, act, dtype=jnp.float32):
    return np.asarray(jck.conv_act(jnp.asarray(x, dtype), jnp.asarray(wt),
                                   jnp.asarray(b), k=k, act=act,
                                   interpret=True).astype(jnp.float32))


def _port(x, wt, b, k, act, dtype=torch.float32):
    return tck.conv_act(torch.from_numpy(x).to(dtype), torch.from_numpy(wt),
                        torch.from_numpy(b), k=k, act=act).float().numpy()


@pytest.mark.parametrize("h,w,c_in,c_out,k", CASES)
@pytest.mark.parametrize("act", [True, False])
def test_plain_matches_jax_conv_act(h, w, c_in, c_out, k, act):
    x, wt, b = _inputs(h * 1000 + c_in * 10 + k, 2, h, w, c_in, c_out, k)
    got, want = _port(x, wt, b, k, act), _jax(x, wt, b, k, act)
    assert got.shape == want.shape == (2, h, w, c_out)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,w,c_in,c_out,k", [CASES[0], CASES[3], CASES[5]])
def test_plain_matches_jax_conv_act_bf16(h, w, c_in, c_out, k):
    x, wt, b = _inputs(7, 2, h, w, c_in, c_out, k)
    got = _port(x, wt, b, k, True, torch.bfloat16)
    want = _jax(x, wt, b, k, True, jnp.bfloat16)
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=BF16_ULP_AT_1)
    # rounded once: the bf16 output is the float32 result on the rounded
    # inputs, rounded, not a bf16 conv plus a bf16 bias
    w16 = torch.from_numpy(wt).bfloat16().float().numpy()
    x16 = torch.from_numpy(x).bfloat16().float().numpy()
    once = torch.from_numpy(_port(x16, w16, b, k, True)).bfloat16()
    np.testing.assert_array_equal(got, once.float().numpy())


def test_multi_image_batches_match_single():
    x, wt, b = _inputs(11, 8, 40, 40, 32, 32, 3)
    batched = _port(x, wt, b, 3, True)
    singles = np.concatenate([_port(x[i:i + 1], wt, b, 3, True)
                              for i in range(8)])
    np.testing.assert_allclose(batched, singles, rtol=2e-5, atol=2e-5)


def test_nchw_layout_is_the_same_function():
    x, wt, b = _inputs(12, 2, 40, 40, 64, 51, 3)
    nhwc = _port(x, wt, b, 3, True)
    nchw = tck.conv_act_nchw(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(wt), torch.from_numpy(b), k=3,
                             act=True)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), nhwc)


@pytest.mark.parametrize("k,act", [(3, True), (1, False)])
def test_grad_matches_jax(k, act):
    """The custom backward (autograd of the plain formulation) against
    jax.grad of the JAX conv_act (its custom VJP), for x, w and b."""
    x, wt, b = _inputs(5, 1, 40, 40, 32, 16, k)

    def jloss(x, w, b):
        return jnp.sum(jck.conv_act(x, w, b, k=k, act=act, interpret=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wt),
                                              jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, wt, b))
    (tck.conv_act(tx, tw, tb, k=k, act=act) ** 2).sum().backward()
    for got, w_ in zip((tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)
    # only the wanted gradients are formed
    tb2 = torch.from_numpy(b).requires_grad_()
    tck.conv_act(torch.from_numpy(x), torch.from_numpy(wt), tb2, k=k,
                 act=act).sum().backward()
    assert tb2.grad is not None


def test_eligible_equals_jax_rule():
    grid = []
    for h, w in [(80, 80), (40, 40), (20, 20), (79, 79), (8, 200), (160, 160),
                 (2, 800), (40, 41), (3, 536)]:
        for c_in in (16, 32, 64, 128, 192, 193, 256):
            for k, stride, groups in [(1, 1, 1), (3, 1, 1), (3, 2, 1),
                                      (5, 1, 1), (3, 1, 2), (3, 1, c_in)]:
                grid.append(((2, h, w, c_in), k, stride, groups, 1))
    grid.append(((2, 80, 80, 64), 3, 1, 1, 2))
    picked = 0
    for args in grid:
        assert tck.eligible(*args) == jck.eligible(*args), args
        picked += tck.eligible(*args)
    assert picked > 30
    # the cases of test_pallas_conv.py::test_eligibility_rules
    ok = tck.eligible
    assert ok((2, 80, 80, 64), 3, 1, 1, 1)
    assert ok((2, 40, 40, 192), 1, 1, 1, 1)
    assert not ok((2, 80, 80, 64), 3, 2, 1, 1)
    assert not ok((2, 80, 80, 64), 5, 1, 1, 1)
    assert not ok((2, 80, 80, 64), 3, 1, 2, 1)
    assert not ok((2, 20, 20, 64), 3, 1, 1, 1)
    assert not ok((2, 80, 80, 256), 3, 1, 1, 1)
    assert not ok((2, 79, 79, 64), 3, 1, 1, 1)


def test_picks_at_640():
    """The convs the rule picks at 640: the JAX package's conv_apply convs
    on the 80x80 and 40x40 planes (30 / 35 / 35) plus the head output
    convs there (conv2d_bias_apply in the JAX package, act off)."""
    for name, want in (("yolov8n", 34), ("yolo11n-pose", 41),
                       ("yolov8n-seg", 41)):
        model = tyolo.YoloModel(tyolo.build_model(name), fused=True)
        picks = tyolo.kernel_picks(model, (640, 640))
        outs = [p for p in picks if p.name.endswith(".out")]
        assert {(p.h, p.w) for p in picks} == {(80, 80), (40, 40)}
        assert all(p.act == (p not in outs) for p in picks)
        assert len(picks) == want, (name, len(picks))
        assert len(picks) - len(outs) == {34: 30, 41: 35}[want]


def _routed_jax(monkeypatch):
    """The JAX model with every eligible fused conv through the JAX
    conv_act in interpret mode."""
    conv_apply, bias_apply = jcommon.conv_apply, jcommon.conv2d_bias_apply

    def kernel_or(fallback, p, x, stride, groups, dilation, act):
        k = p["w"].shape[0]
        if "b" in p and jck.eligible(x.shape, k, stride, groups, dilation):
            w = p["w"]
            return jck.conv_act(x, w.reshape(k * k * w.shape[2], w.shape[3]),
                                p["b"], k=k, act=act, interpret=True)
        return fallback()

    def routed(p, x, *, stride=1, groups=1, dilation=1, act=True, pad=None,
               **kw):
        def fallback():
            return conv_apply(p, x, stride=stride, groups=groups,
                              dilation=dilation, act=act, pad=pad, **kw)
        if pad is not None:
            return fallback()
        return kernel_or(fallback, p, x, stride, groups, dilation, act)

    def routed_bias(p, x, *, stride=1):
        return kernel_or(lambda: bias_apply(p, x, stride=stride), p, x,
                         stride, 1, 1, False)

    monkeypatch.setattr(jcommon, "conv_apply", routed)
    monkeypatch.setattr(jcommon, "conv2d_bias_apply", routed_bias)


def test_routed_yolov8n_matches_jax_route(monkeypatch):
    cfg = jyolo.build_model("yolov8n")
    params = jyolo.fuse_model(jyolo.init_model(jax.random.PRNGKey(0), cfg))
    x = np.random.default_rng(1).uniform(0, 1, (2, 160, 160, 3)).astype(np.float32)
    _routed_jax(monkeypatch)
    want = jax.jit(lambda p, x: jyolo.model_apply(p, x, cfg, pack=False))(
        params, jnp.asarray(x))
    model = tporting.model_from_state_dict(
        tporting.params_from_jax(jax.device_get(params), cfg), cfg).eval()
    model.use_conv_kernel()
    calls = []
    nchw = tcommon.conv_act_nchw
    monkeypatch.setattr(tcommon, "conv_act_nchw",
                        lambda *a, **kw: calls.append(1) or nchw(*a, **kw))
    with torch.no_grad():
        got = tyolo.model_apply(model, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(calls) == len(tyolo.kernel_picks(model, (160, 160))) == 4
    for key in ("box_logits", "cls_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)


def test_pipeline_route_on_the_cpu(monkeypatch):
    """Pipeline(conv_kernel=True) routes the picked convs (four at imgsz
    160) through conv_act_nchw, whose plain version gives the float32
    detections of the default route; an unfused model is refused."""
    kw = dict(weights=CKPT, imgsz=160, half=False, max_det=16)
    off = Pipeline(DetectorConfig(**kw), tracker="bytetrack.yaml",
                   track_slots=16, tracker_max_dets=16, device="cpu")
    on = Pipeline(DetectorConfig(**kw), tracker="bytetrack.yaml",
                  track_slots=16, tracker_max_dets=16, device="cpu",
                  conv_kernel=True)
    calls = []
    nchw = tcommon.conv_act_nchw
    monkeypatch.setattr(tcommon, "conv_act_nchw",
                        lambda *a, **k: calls.append(1) or nchw(*a, **k))
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 60, (320, 320, 3), dtype=np.uint8)
    frame[80:200, 60:150] = 200
    a, b = off.predict(frame), on.predict(frame)
    assert len(calls) == 4
    assert len(a.boxes) == len(b.boxes) >= 1
    np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3)
    with pytest.raises(ValueError, match="fused"):
        Pipeline(DetectorConfig(**kw, fuse=False), tracker="bytetrack.yaml",
                 device="cpu", conv_kernel=True)


def test_wrapper_refuses_what_k7_does_not_take():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError):
        tck.conv_act(x, torch.zeros(9 * 4, 2), torch.zeros(2), k=5, act=True)
    with pytest.raises(ValueError):
        tck.conv_act(x, torch.zeros(9 * 3, 2), torch.zeros(2), k=3, act=True)
    with pytest.raises(ValueError):
        tck.conv_act(x.double(), torch.zeros(9 * 4, 2), torch.zeros(2), k=3,
                     act=True)
    with pytest.raises(ValueError, match="form"):
        tck.conv_act_kernel(x, torch.zeros(9 * 4, 2), torch.zeros(2), k=3,
                            act=True, form="dots")


@pytest.mark.parametrize("k,c_in,c_out", [(3, 51, 80), (1, 51, 51), (3, 16, 128),
                                          (1, 192, 200)])
def test_pack_mma_round_trips_with_zero_padding(k, c_in, c_out):
    """pack_mma -> (chunks, k*k, 2, N_pad, 8) bf16: unpack gives the
    bf16-rounded weight back, and every padded input or output channel
    is zero (C_in padded to a whole number of the kernel's stages, C_out
    to its wgmma width)."""
    w = torch.from_numpy(np.random.default_rng(c_in).normal(
        0, 1, (k * k * c_in, c_out)).astype(np.float32))
    blob = tck.pack_mma(w, k)
    n_tile = tck.mma_n_tile(c_out)
    chunks = tck.mma_chunks(c_in, k)
    assert blob.dtype == torch.bfloat16 and blob.is_contiguous()
    assert blob.shape[:3] == (chunks, k * k, 2) and blob.shape[4] == 8
    assert blob.shape[3] % n_tile == 0 and blob.shape[3] >= c_out
    assert chunks * 16 % (64 if k == 1 else 16) == 0 and chunks * 16 >= c_in
    assert torch.equal(tck.unpack_mma(blob, k, c_in, c_out),
                       w.to(torch.bfloat16))
    full = tck.unpack_mma(blob, k, chunks * 16, blob.shape[3]).reshape(
        k * k, chunks * 16, blob.shape[3])
    assert not full[:, c_in:].any() and not full[:, :, c_out:].any()
    assert (tck.mma_n_tile(51), tck.mma_n_tile(80), tck.mma_n_tile(300)) == (
        64, 80, 128)


def _mma_emulation(x, blob, b, k, act, c_out):
    """The mma form's decomposition in plain PyTorch, from the packed
    weights: per 16-channel chunk (zero past C_in) and per tap, dy outer
    and dx inner, the shifted zero-padded input slab times the chunk's
    (N_pad, 16) weights, summed in float32 into one accumulator; then
    + float32 bias, SiLU, one rounding to bf16. x (n, c_in, h, w) bf16
    -> (n, h, w, c_out)."""
    n, c_in, h, w = x.shape
    chunks, _, _, n_pad, _ = blob.shape
    r = k // 2
    xp = torch.zeros((n, chunks * 16, h + 2 * r, w + 2 * r))
    xp[:, :c_in, r:r + h, r:r + w] = x.float()
    acc = torch.zeros((n, h, w, n_pad))
    for c in range(chunks):
        for tap in range(k * k):
            dy, dx = divmod(tap, k)
            a = xp[:, 16 * c:16 * c + 16, dy:dy + h, dx:dx + w].permute(0, 2, 3, 1)
            wm = blob[c, tap].float().permute(1, 0, 2).reshape(n_pad, 16)
            acc = acc + a @ wm.T
    y = acc[..., :c_out] + b
    if act:
        y = y * torch.sigmoid(y)
    return y.to(torch.bfloat16)


def _picks_at_160():
    shapes = set()
    for name in ("yolov8n", "yolo11n-pose", "yolov8n-seg"):
        model = tyolo.YoloModel(tyolo.build_model(name), fused=True)
        shapes |= {p[1:] for p in tyolo.kernel_picks(model, (160, 160))}
    return sorted(shapes)


def test_mma_decomposition_matches_plain_on_the_picks_at_160():
    """The mma form's chunk-by-chunk, tap-by-tap float32 sums with one
    rounding equal conv_act_plain within one bf16 unit at 1.0, scaled by
    max(1, |ref|), on every conv shape the rule picks at imgsz 160."""
    shapes = _picks_at_160()
    assert shapes
    for h, w, c_in, c_out, k, act in shapes:
        x, wt, b = _inputs(h + c_in + c_out, 2, h, w, c_in, c_out, k)
        xb = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
        wt, b = torch.from_numpy(wt), torch.from_numpy(b)
        got = _mma_emulation(xb, tck.pack_mma(wt, k), b, k, act, c_out).float()
        want = tck.conv_act_plain(xb.permute(0, 2, 3, 1), wt, b, k=k,
                                  act=act).float()
        err = ((got - want).abs() / want.abs().clamp(min=1.0)).max()
        assert float(err) <= BF16_ULP_AT_1, ((h, w, c_in, c_out, k), float(err))


def test_mma_form_takes_bfloat16_only():
    """The dtype rule: bfloat16 runs mma, float32 taps; an explicit mma
    on float32 raises (the tensor cores take float32 only as TF32), on
    the CPU too."""
    assert tck.default_form(torch.bfloat16) == "mma"
    assert tck.default_form(torch.float32) == "taps"
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="bfloat16"):
        tck.conv_act_kernel(x, torch.zeros(9 * 4, 2), torch.zeros(2), k=3,
                            act=True, form="mma")
    got = tck.conv_act_kernel(x.bfloat16(), torch.zeros(9 * 4, 2),
                              torch.ones(2), k=3, act=False, form="mma")
    assert got.dtype == torch.bfloat16 and bool((got == 1).all())


def test_route_caches_the_mma_blob():
    """A routed Conv keeps pack_mma of its float32 weight once per device
    and dtype for bfloat16 activations, and none for float32."""
    conv = tcommon.Conv(64, 32, 3, 1, act=True, fused=True)
    with torch.no_grad():
        conv.w.normal_(0, 0.05)
    conv.use_conv_kernel()
    x = torch.zeros(1, 64, 40, 40)
    with torch.no_grad():
        conv(x)
        assert conv._k7[2] is None
        conv(x.bfloat16())
    w, _ = conv._k7_src
    assert torch.equal(conv._k7[2], tck.pack_mma(w, 3))
