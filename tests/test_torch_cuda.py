"""The port's CUDA kernels against their plain PyTorch versions, and the
batched pipeline on the card against the CPU. These need an NVIDIA GPU
with nvcc and skip without one. The GPU machine has no JAX, so run them
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernels round every operation as their plain versions
do, so K1-K4 outputs must be identical; K5 sums in another order
than its plain version, across a trimming threshold that is a step, so
its params agree within 1e-4 base px and 1e-6 (a wrong damping
constant moves them by more than 3e-3 px, a step more or less by
pixels), on pans it has converged on and on rotated and scaled pairs
it has not (one step per level), two of its launches are
bit-identical, each pair of an N=33 launch is bit-identical to that
pair launched alone, and planes strided by rows and pairs give the
contiguous planes' params bit for bit; K6 (the fused OSNet stage) sums in another order than
its plain version, so it is held to 1e-4 in float32 (its 3xTF32 forms
keep about 21 bits of each product); in bfloat16 its
tensor-core form adds a chunk's products in the tensor cores' order,
and a flipped rounding propagates (a gate value moves a whole channel;
exact float64 sums differ from the plain version as much), so it is
held to a mean |err| within 2e-4 of the largest output (the bar of its
plain version against the JAX kernel), one block a crop or a cluster of
blocks a crop alike; its launches are
bit-identical, at every OSNet width; K3
must equal its plain version in both forms (benefit block in shared
memory, and in the global scratch), on random, tied, tracker-shaped and
empty problems; K7 (the fused conv) sums in another
order than its plain version (cuDNN's float32 conv with TF32 off):
float32 within 2e-5 x max(1, |ref|), bfloat16 within one bf16 unit at
1.0 of the output scaled by max(1, |ref|), in every form of the dtype
(mma, the tensor-core form, in bfloat16 only) and both layouts, two
launches bit-identical; K8 (the int8 conv) sums exactly, so its int32
sums and its act=False outputs equal its plain version's bit for bit,
and its SiLU outputs within 4 float32 ulps x max(1, |ref|) (one bf16
unit at 1.0 in bfloat16): its expf and division against PyTorch's
sigmoid; the pipelines compare float32 runs with TF32 off, boxes (and keypoints) within 1e-3 px, identical ids (and mask
polygons); the offline tools: the AFLink net's logits within 1e-5 x
max(1, |logit|) of the CPU's with the same decisions, its link costs
within 1e-5 and the same merges, and ``eval_mot --public`` printing the
CPU's JSON lines; training: a train step from the synth160 asset within
1e-4 relative of the CPU's loss and each gradient within 1e-4 of the
CPU's norm of it (float32, TF32 off: the convolutions sum in another
order), three steps run twice equal bit for bit, K7's gradients within 1e-5 x max(1, |g|) of the plain version's
autograd, and the unfused OSNet within 1e-5 of the folded one and of the
CPU's.
"""

import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.models.osnet import (
    OsnetConfig,
    init_osnet,
    osnet_from_state_dict,
)
from strongsort_yolo_tpu_torch.ops.crops import banded_prep, pyramid_stack
from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import auction, auction_plain
from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import (
    FORMS,
    conv_act,
    conv_act_kernel,
    conv_act_plain,
)
from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import (
    banded_crop,
    banded_crop_frames,
    banded_crop_plain,
)
from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import lk_pyramid, lk_pyramid_plain
from strongsort_yolo_tpu_torch.ops.cuda.nms_kernel import nms_keep, nms_keep_plain
from strongsort_yolo_tpu_torch.ops.cuda import _build
from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import (
    EPS_REL,
    max_rounds_for,
)
from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import (
    cluster_split,
    os_stage,
    os_stage_plain,
    stage_form,
    stage_specs,
    stage_weights,
)
from strongsort_yolo_tpu_torch.ops.cuda.quant_kernel import (
    conv_s8,
    conv_s8_plain,
    pack_s8,
    quantize_codes,
    quantize_codes_plain,
)
from strongsort_yolo_tpu_torch.ops.cuda.resize_kernel import letterbox_u8
from strongsort_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params
from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
from strongsort_yolo_tpu_torch.track.gmc_flow import pyramid
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

pytestmark = pytest.mark.cuda

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
CKPT = os.path.join(ASSETS, "yolov8n_synth160.npz")
OSNET = os.path.join(ASSETS, "osnet_x0_25_synth.npz")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("hw,size", [((1080, 1920), 640), ((240, 320), 160),
                                     ((720, 1280), 640), ((1920, 1080), 640),
                                     ((481, 853), 640), ((1080, 1920), 636),
                                     ((64, 8150), 640), ((64, 8200), 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_letterbox_kernel_equals_plain(dev, hw, size, dtype):
    """Among the geometries: a size that is not a multiple of 8 (the
    scalar tail of each run), and frames 8150 and 8200 pixels wide, whose
    two source rows with the byte / 255 table fill most of a block's
    48 KB of shared memory or more."""
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    ).to(dev)
    lp = letterbox_params(*hw, size)
    before = letterbox_u8.launches
    got = letterbox_u8(frames, lp, dtype=dtype)
    assert letterbox_u8.launches == before + 1
    assert torch.equal(got, letterbox(frames, lp, dtype=dtype))


@pytest.mark.parametrize("k", [1, 100, 512])
def test_nms_kernel_equals_plain(dev, k):
    rng = np.random.default_rng(k)
    s = 4
    xy = rng.uniform(0, 300, (s, k, 2))
    wh = rng.uniform(10, 80, (s, k, 2))
    boxes = torch.from_numpy(
        np.concatenate([xy, xy + wh], -1).astype(np.float32)
    ).to(dev)
    conf = torch.from_numpy(
        -np.sort(-rng.uniform(0, 1, (s, k)), 1).astype(np.float32)
    ).to(dev)
    got = nms_keep(boxes, conf, iou_thres=0.4, conf_thres=0.3)
    assert torch.equal(got, nms_keep_plain(boxes, conf, iou_thres=0.4,
                                           conf_thres=0.3))
    with pytest.raises(ValueError):
        nms_keep(torch.zeros(1, 513, 4, device=dev),
                 torch.zeros(1, 513, device=dev), iou_thres=0.4,
                 conf_thres=0.3)


@pytest.mark.parametrize("case", ["k31", "k33", "all invalid", "chains"])
def test_nms_kernel_equals_plain_edges(dev, case):
    """K2 at a partial scan tile (K = 31), one row past a tile (K = 33),
    with every row invalid, and on suppression chains across a tile
    boundary (A kills B, B would kill C, so C survives), with class
    offsets: the keep mask equals the plain version's bit for bit."""
    rng = np.random.default_rng(len(case))
    s, k = 3, {"k31": 31, "k33": 33}.get(case, 100)
    xy = rng.uniform(0, 300, (s, k, 2))
    wh = rng.uniform(10, 80, (s, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    conf = -np.sort(-rng.uniform(0, 1, (s, k)), 1)
    if case == "all invalid":
        conf = conf * 0.25  # every score below conf_thres 0.3
    if case == "chains":  # rows 30, 31, 32 (and 62, 63, 64) chain by 25 px
        for a, y in ((30, 400.0), (62, 600.0)):
            for m in range(3):
                boxes[:, a + m] = [400.0 + 25 * m, y, 460.0 + 25 * m, y + 60]
        boxes[:, 70:] += rng.integers(0, 3, (s, k - 70, 1)) * 7680.0
        conf = np.maximum(conf, 0.31)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    conf = torch.from_numpy(conf.astype(np.float32)).to(dev)
    got = nms_keep(boxes, conf, iou_thres=0.4, conf_thres=0.3)
    want = nms_keep_plain(boxes, conf, iou_thres=0.4, conf_thres=0.3)
    assert torch.equal(got, want)
    if case == "all invalid":
        assert not bool(got.any())
    if case == "chains":
        assert got[:, [30, 32, 62, 64]].all() and not got[:, [31, 63]].any()


@pytest.mark.parametrize("r,c", [(16, 16), (256, 128), (37, 5), (256, 256),
                                 (512, 250), (1100, 300)])
def test_auction_kernel_equals_plain(dev, r, c):
    rng = np.random.default_rng(r * c)
    p = 6
    cost = rng.uniform(0, 1, (p, r, c)).astype(np.float32)
    cost[1] = np.round(cost[1] * 4) / 4  # ties
    rv = rng.uniform(size=(p, r)) < 0.5
    cv = rng.uniform(size=(p, c)) < 0.7
    rv[2] = False  # empty problem
    args = (torch.from_numpy(cost).to(dev), torch.full((p,), 0.8, device=dev),
            torch.from_numpy(rv).to(dev), torch.from_numpy(cv).to(dev))
    got = auction(*args)
    want = auction_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _auction_form(args, shared):
    """K3 in the form asked for: the benefit block in shared memory, or
    in a (P, R, C) global scratch (the wrapper picks by size alone)."""
    cost, thresh, rv, cv = args
    p, r, c = cost.shape
    r2c = torch.empty((p, r), dtype=torch.int32, device=cost.device)
    c2r = torch.empty((p, c), dtype=torch.int32, device=cost.device)
    scratch = None if shared else torch.empty((p, r, c), device=cost.device)
    err = _build.lib().ssyt_auction(
        cost.data_ptr(), thresh.data_ptr(), rv.data_ptr(), cv.data_ptr(),
        r2c.data_ptr(), c2r.data_ptr(),
        None if scratch is None else scratch.data_ptr(), p, r, c, EPS_REL,
        max_rounds_for(r), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "auction")
    return r2c, c2r


@pytest.mark.parametrize("case", ["tracker", "no_rows", "ties"])
@pytest.mark.parametrize("shared", [True, False])
def test_auction_kernel_forms_at_the_tracker_shape(dev, case, shared):
    """(8, 256, 128), the trackers' problems: about 50 valid rows and
    columns with a near-diagonal of good matches, all rows invalid, and
    costs rounded to quarters; both forms, bit-identical to the plain
    version, and two launches alike."""
    rng = np.random.default_rng(len(case))
    p, r, c = 8, 256, 128
    cost = rng.uniform(0, 1, (p, r, c)).astype(np.float32)
    rv = np.arange(r)[None, :] < rng.integers(40, 60, (p, 1))
    cv = np.arange(c)[None, :] < rng.integers(40, 60, (p, 1))
    if case == "tracker":
        cost[:] = 1.0
        for k in range(p):
            n = 45
            cost[k, np.arange(n), np.arange(n)] = rng.uniform(0.05, 0.4, n)
            cost[k, np.arange(n), np.arange(1, n + 1)] = rng.uniform(0.5, 0.9, n)
    elif case == "no_rows":
        rv[:] = False
    else:
        cost = np.round(cost * 4) / 4
    args = (torch.from_numpy(cost).to(dev), torch.full((p,), 0.8, device=dev),
            torch.from_numpy(rv).to(dev), torch.from_numpy(cv).to(dev))
    got, again = _auction_form(args, shared), _auction_form(args, shared)
    want = auction_plain(*args)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (int((got[0] >= 0).sum()) > 0) == (case != "no_rows")


def test_batched_pipeline_card_equals_cpu(dev):
    rng = np.random.default_rng(3)
    frames = (rng.uniform(0, 0.3, (4, 2, 320, 320, 3)) * 255).astype(np.uint8)
    for t in range(4):
        frames[t, :, 60 + 3 * t:160 + 3 * t, 80:190] = 210
    outs = {}
    for device in ("cpu", "cuda"):
        pipe = Pipeline(
            DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16),
            tracker="bytetrack.yaml", track_slots=16, tracker_max_dets=16,
            device=device,
        )
        bp = BatchedPipeline(pipe, 2, (320, 320))
        outs[device] = [bp.step(f) for f in frames]
    for a_t, b_t in zip(outs["cpu"], outs["cuda"]):
        for a, b in zip(a_t, b_t):
            assert len(a) == len(b)
            np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3)
            np.testing.assert_array_equal(b.boxes.id, a.boxes.id)


def _crop_boxes(rng, n, h, w):
    xy = rng.uniform(-30, [w - 10, h - 10], (n, 2))
    frac = rng.choice([0.05, 0.2, 0.5, 0.95], (n, 1))
    wh = rng.uniform(0.3, 1.0, (n, 2)) * frac * np.array([w, h])
    edges = np.array([[0, 0, 0, 0], [w - 1, h - 1, w + 40, h + 40],
                      [-50, 100, 40, 300], [w - 40, 100, w + 50, 300],
                      [100, -60, 200, 40], [100, h - 40, 200, h + 60],
                      [0, 0, w, h]])
    return np.concatenate([np.concatenate([xy, xy + wh], 1), edges]).astype(
        np.float32)


@pytest.mark.parametrize("hw", [(1080, 1920), (600, 1000), (481, 853)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_crop_kernel_equals_plain(dev, hw, dtype):
    rng = np.random.default_rng(hw[0])
    s = 3
    frames = torch.from_numpy(
        rng.uniform(0, 1, (s, 3, *hw)).astype(np.float32)).to(dev, dtype)
    pyr = pyramid_stack(frames)
    boxes = _crop_boxes(rng, 61, *hw)
    slot_frame = torch.from_numpy(
        rng.integers(0, s, len(boxes)).astype(np.int32)).to(dev)
    scal, ints = banded_prep(torch.from_numpy(boxes).to(dev), hw, pyr.dims,
                             (128, 64))
    assert set(ints[:, 2].tolist()) == set(range(len(pyr.dims)))
    before = banded_crop.launches
    got = banded_crop(pyr, scal, ints, slot_frame)
    assert banded_crop.launches == before + 1
    want = banded_crop_plain(pyr, scal, ints, slot_frame)
    assert torch.equal(got, want)
    # the fixed-width form: slot b*M + i from frame b
    fixed_boxes = torch.from_numpy(np.stack([boxes[:20]] * s)).to(dev)
    fixed = banded_crop_frames(frames, fixed_boxes)
    assert fixed.shape == (s, 20, 3, 128, 64)
    scal_f, ints_f = banded_prep(fixed_boxes.reshape(-1, 4), hw, pyr.dims,
                                 (128, 64))
    fixed_frame = (torch.arange(s * 20, device=dev) // 20).to(torch.int32)
    assert torch.equal(fixed.reshape(s * 20, 3, 128, 64), banded_crop_plain(
        pyr, scal_f, ints_f, fixed_frame))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_crop_single_slot(dev, dtype):
    """One slot: a grid of one slot's tiles; a box across the frame's
    right and bottom edges of 481x853 frames."""
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(
        rng.uniform(0, 1, (2, 3, 481, 853)).astype(np.float32)).to(dev, dtype)
    pyr = pyramid_stack(frames)
    scal, ints = banded_prep(
        torch.tensor([[700.0, 300.0, 900.0, 520.0]], device=dev), (481, 853),
        pyr.dims, (128, 64))
    slot_frame = torch.ones(1, dtype=torch.int32, device=dev)
    got = banded_crop(pyr, scal, ints, slot_frame)
    assert got.shape == (1, 3, 128, 64)
    assert torch.equal(got, banded_crop_plain(pyr, scal, ints, slot_frame))


@pytest.mark.parametrize("hw", [(1080, 1920), (481, 853)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_crop_partial_tiles(dev, hw, dtype):
    """out_hw (100, 40): a slot's last tile of rows holds 4 of 16 and its
    one tile of columns 40 of 64, so runs end in scalar stores."""
    rng = np.random.default_rng(hw[1])
    s, out_hw = 2, (100, 40)
    frames = torch.from_numpy(
        rng.uniform(0, 1, (s, 3, *hw)).astype(np.float32)).to(dev, dtype)
    pyr = pyramid_stack(frames)
    boxes = _crop_boxes(rng, 25, *hw)
    slot_frame = torch.from_numpy(
        rng.integers(0, s, len(boxes)).astype(np.int32)).to(dev)
    scal, ints = banded_prep(torch.from_numpy(boxes).to(dev), hw, pyr.dims,
                             out_hw)
    got = banded_crop(pyr, scal, ints, slot_frame, out_hw)
    assert got.shape == (len(boxes), 3, *out_hw)
    assert torch.equal(got, banded_crop_plain(pyr, scal, ints, slot_frame,
                                              out_hw))


def test_banded_crop_rejects_what_it_does_not_take(dev):
    pyr = pyramid_stack(torch.zeros(1, 3, 64, 64, device=dev))
    scal = torch.zeros(4, 6, device=dev)
    ints = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        banded_crop(pyr, scal, ints, torch.zeros(4, dtype=torch.int64,
                                                 device=dev))
    with pytest.raises(ValueError):
        banded_crop(pyr._replace(stack=pyr.stack.half()), scal, ints,
                    torch.zeros(4, dtype=torch.int32, device=dev))


def test_strongsort_pipeline_card_equals_cpu(dev, reid_fused=False,
                                            reid_weights=OSNET):
    rng = np.random.default_rng(4)
    frames = (rng.uniform(0, 0.3, (6, 2, 320, 320, 3)) * 255).astype(np.uint8)
    for t in range(6):
        frames[t, :, 60 + 3 * t:160 + 3 * t, 80:150] = 210
        frames[t, :, 170:250, 200 - 2 * t:270 - 2 * t] = 140
    outs = {}
    for device in ("cpu", "cuda"):
        pipe = Pipeline(
            DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16),
            tracker=StrongSortConfig(gmc_method="none"), track_slots=16,
            tracker_max_dets=16, reid_weights=reid_weights,
            reid_fused=reid_fused, device=device,
        )
        bp = BatchedPipeline(pipe, 2, (320, 320))
        outs[device] = [bp.step(f) for f in frames]
    rows = 0
    for a_t, b_t in zip(outs["cpu"], outs["cuda"]):
        for a, b in zip(a_t, b_t):
            assert len(a) == len(b)
            np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3)
            np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
            rows += len(a)
    assert rows > 0


def _smooth_planes(n, h=180, w=320, seed=0, affine=False):
    """n periodic sum-of-sinusoid images and the same images panned
    (np.roll, an exact translation) by a different (dx, dy) each; pair
    n - 1 carries noise, so the trimming threshold is active. With
    ``affine`` the current image is instead rotated and scaled about the
    centre as well as panned: the sinusoids evaluated at the moved
    coordinates, so nothing is resampled; no pair is noisy then, because
    on a noisy pair far from convergence a change of one unit in the
    last place of the input can move a pixel across the trimming
    threshold and the result by 2.6e-4 px (seen with the plain version),
    more than the tolerance."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    prev, cur = [], []
    for k in range(n):
        waves = []
        for _ in range(12):
            fy, fx = rng.integers(1, 6) / h, rng.integers(1, 6) / w
            waves.append((fx, fy, rng.uniform(10, 40),
                          rng.uniform(0, 2 * np.pi)))

        def image(xs, ys):
            img = np.full((h, w), 128.0, np.float32)
            for fx, fy, amp, ph in waves:
                img += amp * np.sin(2 * np.pi * (fx * xs + fy * ys) + ph)
            return img

        img = image(x, y)
        dx, dy = (int(v) for v in rng.integers(-20, 21, 2))
        if affine:  # cur(q) = prev(a^-1 q), a about the centre
            th, sc = rng.uniform(-0.03, 0.03), rng.uniform(0.97, 1.03)
            cx, cy = (w - 1) / 2, (h - 1) / 2
            u, v = x - cx - dx, y - cy - dy
            c = image((np.cos(th) * u + np.sin(th) * v) / sc + cx,
                      (-np.sin(th) * u + np.cos(th) * v) / sc + cy)
        else:
            c = np.roll(img, (dy, dx), axis=(0, 1))
        if k == n - 1 and not affine:
            c = c + rng.normal(0, 20, c.shape).astype(np.float32)
        prev.append(img)
        cur.append(c)
    return (torch.from_numpy(np.stack(prev)), torch.from_numpy(np.stack(cur)))


def _assert_lk_close(got, want):
    """1e-4 base px on the translation, 1e-6 on the linear part."""
    d = (got.cpu() - want).abs()
    assert float(d[:, [2, 5]].max()) * 160 <= 1e-4, d
    assert float(d[:, [0, 1, 3, 4]].max()) <= 1e-6, d


def _lk_twice(dev, pp, pc, params, iters):
    """Two K5 launches on the same input: counted, and bit-identical."""
    before = lk_pyramid.launches
    got = lk_pyramid([x.to(dev) for x in pp], [x.to(dev) for x in pc],
                     params.to(dev), iters)
    again = lk_pyramid([x.to(dev) for x in pp], [x.to(dev) for x in pc],
                       params.to(dev), iters)
    torch.cuda.synchronize()
    assert lk_pyramid.launches == before + 2
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("n,levels", [(1, 3), (8, 3), (33, 3), (5, 1)])
def test_lk_kernel_equals_plain(dev, n, levels):
    """K5 against its plain version on the CPU, on pans it converges on;
    two launches on the same input are bit-identical (no atomics)."""
    prev, cur = _smooth_planes(n, seed=n)
    pp, pc = pyramid(prev)[:levels], pyramid(cur)[:levels]
    params = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]).repeat(n, 1)
    iters = (2, 5, 8) if levels == 3 else (8,)
    want = lk_pyramid_plain(pp, pc, params, iters)
    _assert_lk_close(_lk_twice(dev, pp, pc, params, iters), want)


@pytest.mark.parametrize("n", [3, 8])
def test_lk_kernel_equals_plain_unconverged(dev, n):
    """Rotated, scaled and panned pairs with one Gauss-Newton step per
    level, far from converged: each step's arithmetic shows in the
    result, which must still agree with the plain version."""
    prev, cur = _smooth_planes(n, seed=40 + n, affine=True)
    pp, pc = pyramid(prev), pyramid(cur)
    params = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]).repeat(n, 1)
    want = lk_pyramid_plain(pp, pc, params, (1, 1, 1))
    done = lk_pyramid_plain(pp, pc, params, (2, 5, 8))
    assert float((want - done).abs()[:, [2, 5]].max()) * 160 > 0.1
    _assert_lk_close(_lk_twice(dev, pp, pc, params, (1, 1, 1)), want)


def test_lk_kernel_rejects_what_it_does_not_take(dev):
    plane = torch.zeros(2, 45, 80, device=dev)
    params = torch.zeros(2, 6, device=dev)
    with pytest.raises(ValueError):  # float64 params
        lk_pyramid([plane], [plane], params.double(), (2,))
    with pytest.raises(ValueError):  # pair count differs
        lk_pyramid([plane], [plane[:1]], params, (2,))
    with pytest.raises(ValueError):  # a plane on the CPU
        lk_pyramid([plane], [plane.cpu()], params, (2,))
    with pytest.raises(ValueError):  # more levels than the kernel takes
        lk_pyramid([plane] * 4, [plane] * 4, params, (2, 2, 2, 2))
    with pytest.raises(ValueError):  # not one iteration count per level
        lk_pyramid([plane] * 2, [plane] * 2, params, (2,))


def test_lk_kernel_pair_independent_of_batch(dev):
    """Each pair of an N=33 launch is bit-identical to that pair launched
    alone: a pair's cluster and the bands of its levels depend on the
    level shapes only, never on N."""
    prev, cur = _smooth_planes(33, seed=7)
    pp = [x.to(dev) for x in pyramid(prev)]
    pc = [x.to(dev) for x in pyramid(cur)]
    params = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                          device=dev).repeat(33, 1)
    got = lk_pyramid(pp, pc, params, (2, 5, 8))
    for k in range(33):
        one = lk_pyramid([x[k:k + 1] for x in pp], [x[k:k + 1] for x in pc],
                         params[k:k + 1], (2, 5, 8))
        assert torch.equal(one[0], got[k]), k


def test_lk_kernel_reads_strided_planes(dev):
    """K5 reads the planes where they lie: planes whose rows and pairs
    are strided (views into wider buffers) give the contiguous launch's
    params bit for bit; a plane whose columns are strided raises."""
    prev, cur = _smooth_planes(4, seed=11)
    pp = [x.to(dev) for x in pyramid(prev)]
    pc = [x.to(dev) for x in pyramid(cur)]
    params = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                          device=dev).repeat(4, 1)
    want = lk_pyramid(pp, pc, params, (2, 5, 8))

    def padded(x):  # the same values inside a wider, taller buffer
        n, h, w = x.shape
        buf = torch.full((n + 1, h + 3, w + 7), float("nan"), device=dev)
        buf[1:, 2:2 + h, 3:3 + w] = x
        return buf[1:, 2:2 + h, 3:3 + w]

    views = [padded(x) for x in pp], [padded(x) for x in pc]
    assert not views[0][0].is_contiguous()
    assert torch.equal(lk_pyramid(*views, params, (2, 5, 8)), want)
    wide = torch.zeros(4, 45, 160, device=dev)[:, :, ::2]  # column stride 2
    with pytest.raises(ValueError):
        lk_pyramid([wide], [wide], params, (2,))


def test_flow_pipeline_card_equals_cpu(dev):
    """BoT-SORT with gmc_method="flow_tpu" over 2 panned streams: the
    card (K1-K3, K5) against the CPU (plain versions), float32 with TF32
    off; equal ids, boxes within 1e-3 px, and equal warps within 2e-3
    (the LK's sums run in another order on the two sides)."""
    rng = np.random.default_rng(5)
    bg = (rng.uniform(0, 0.3, (2, 240, 320, 3)) * 255).astype(np.uint8)
    frames = []
    for t in range(6):
        f = np.stack([np.roll(bg[0], (-2 * t, 3 * t), axis=(0, 1)),
                      np.roll(bg[1], (t, -4 * t), axis=(0, 1))])
        f[:, 60 + 3 * t:140 + 3 * t, 80:170] = 210
        frames.append(f)
    outs, warps = {}, {}
    for device in ("cpu", "cuda"):
        pipe = Pipeline(
            DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16),
            tracker=ByteTrackConfig(tracker_type="botsort",
                                    gmc_method="flow_tpu"),
            track_slots=16, tracker_max_dets=16, device=device,
        )
        bp = BatchedPipeline(pipe, 2, (240, 320))
        before = lk_pyramid.launches
        outs[device], warps[device] = [], []
        for f in frames:
            outs[device].append(bp.step(f))
            warps[device].append(bp.last_warps.cpu().numpy())
        if device == "cuda":
            assert lk_pyramid.launches == before + len(frames)
    np.testing.assert_allclose(warps["cuda"], warps["cpu"], atol=2e-3)
    rows = 0
    for a_t, b_t in zip(outs["cpu"], outs["cuda"]):
        for a, b in zip(a_t, b_t):
            assert len(a) == len(b)
            np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3)
            np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
            rows += len(a)
    assert rows > 0


def test_track_chunk_card_equals_track_calls(dev):
    """On the card in float32: one track_chunk of T frames (one detect
    batch, one K5 launch) against T track calls (T launches), BoT-SORT
    with flow_tpu; equal ids and boxes within 1e-3 px."""
    rng = np.random.default_rng(6)
    bg = (rng.uniform(0, 0.3, (240, 320, 3)) * 255).astype(np.uint8)
    frames = []
    for t in range(6):
        f = np.roll(bg, (2 * t, -3 * t), axis=(0, 1))
        f[60 + 2 * t:140 + 2 * t, 70:160] = 200
        frames.append(f)
    rows = {}
    for mode in ("track", "chunk"):
        pipe = Pipeline(
            DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16),
            tracker=ByteTrackConfig(tracker_type="botsort",
                                    gmc_method="flow_tpu"),
            track_slots=16, tracker_max_dets=16, device=dev,
        )
        before = lk_pyramid.launches
        if mode == "track":
            out = [pipe.track(f) for f in frames]
        else:
            out = pipe.track_chunk(np.stack(frames))
        assert lk_pyramid.launches == before + (len(frames) if mode == "track"
                                                else 1)
        rows[mode] = [(r.boxes.id, r.boxes.xyxy) for r in out]
    assert sum(len(i) for i, _ in rows["track"]) > 0
    for (wi, wb), (gi, gb) in zip(rows["track"], rows["chunk"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gb, wb, atol=1e-3)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["stage2", "stage3", "stage4-gap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["osnet_x0_25", "osnet_x0_5", "osnet_x0_75",
                                     "osnet_x1_0"])
def test_os_stage_kernel_equals_plain(dev, i, dtype, variant):
    cfg = OsnetConfig(variant=variant)
    model = osnet_from_state_dict(
        init_osnet(cfg, torch.Generator().manual_seed(i)), cfg)
    spec = stage_specs(cfg.channels)[i]
    w = stage_weights(model, i, dtype).to(dev)
    rng = np.random.default_rng(i)
    x = torch.from_numpy(rng.normal(0, 1, (37, spec.c_in, spec.h, spec.w))
                         .astype(np.float32)).to(dev, dtype)
    before = os_stage.launches
    got, again = os_stage(x, w, spec), os_stage(x, w, spec)
    assert os_stage.launches == before + 2
    want = os_stage_plain(x, w, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_k6_close(got, want, stage_form(spec, dtype))
    assert os_stage(x[:0], w, spec).shape == (0, *spec.out_shape)
    with pytest.raises(ValueError):  # weights packed for another dtype
        os_stage(x.double(), w, spec)


def _assert_k6_close(got, want, form):
    """K6's bars (see the note at the top): float32 within 1e-4; bfloat16,
    which takes only the tensor-core forms (one block or a cluster of
    blocks a crop), the mean |err| within 2e-4 of the largest output."""
    if got.dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4
    else:
        assert form.startswith("tensor cores")
        diff = (got.float() - want.float()).abs()
        assert float(diff.mean()) <= 2e-4 * float(want.float().abs().max())


@pytest.mark.parametrize("i", [0, 1, 2], ids=["stage2", "stage3", "stage4-gap"])
@pytest.mark.parametrize("g", [0, 1, 7, 480])
def test_os_stage_tensor_cores_x0_25(dev, i, g):
    """The x0_25 stages in bfloat16 take the tensor-core form: at G = 480
    (the fused path's batch) within the bar of the plain version, two
    launches bit-identical; at G = 0, 1 and 7, the same crops' output
    of the G = 480 launch, bit for bit (a crop's output does not depend
    on the batch around it)."""
    cfg = OsnetConfig()
    model = osnet_from_state_dict(
        init_osnet(cfg, torch.Generator().manual_seed(1)), cfg)
    spec = stage_specs(cfg.channels)[i]
    assert stage_form(spec, torch.bfloat16) == "tensor cores"
    w = stage_weights(model, i, torch.bfloat16).to(dev)
    x = torch.from_numpy(np.random.default_rng(i).normal(
        0, 1, (480, spec.c_in, spec.h, spec.w)).astype(np.float32)).to(
            dev, torch.bfloat16)
    full, again = os_stage(x, w, spec), os_stage(x, w, spec)
    got = os_stage(x[:g], w, spec)
    torch.cuda.synchronize()
    assert got.shape == (g, *spec.out_shape)
    assert torch.equal(full, again) and torch.equal(got, full[:g])
    if g == 480:
        _assert_k6_close(full, os_stage_plain(x, w, spec), "tensor cores")


def test_os_stage_forms_by_width(dev):
    """The form each stage takes: the tensor cores at every stage, one
    block a crop wherever a crop fits a block, elsewhere a cluster of
    blocks a crop at the split of cluster_split. In bfloat16 one block
    for all of x0_25, stages 3-4 of x0_5 and x0_75 and stage 4 of x1_0,
    each cluster block's shared memory such that two blocks share an SM's
    228 KB (1 KB reserved a block); in float32 (3xTF32) one block for
    x0_25's stage 3 and every stage 4, a cluster for the seven others,
    two blocks an SM wherever the split allows it."""
    cluster = {torch.bfloat16: {("osnet_x0_5", 0): 4, ("osnet_x0_75", 0): 8,
                                ("osnet_x1_0", 0): 8, ("osnet_x1_0", 1): 4},
               torch.float32: {("osnet_x0_25", 0): 4, ("osnet_x0_5", 0): 8,
                               ("osnet_x0_5", 1): 4, ("osnet_x0_75", 0): 8,
                               ("osnet_x0_75", 1): 4, ("osnet_x1_0", 0): 8,
                               ("osnet_x1_0", 1): 4}}
    shared = {("osnet_x0_75", 0), ("osnet_x1_0", 0), ("osnet_x1_0", 1)}
    lib = _build.lib()
    for variant in ("osnet_x0_25", "osnet_x0_5", "osnet_x0_75", "osnet_x1_0"):
        for i, spec in enumerate(stage_specs(OsnetConfig(variant=variant).channels)):
            args = (spec.c_in, spec.c_out, spec.mid, spec.h, spec.w)
            for dtype, prefix in ((torch.bfloat16, "tensor cores"),
                                  (torch.float32, "tensor cores, 3xTF32")):
                bf16 = int(dtype == torch.bfloat16)
                k = cluster[dtype].get((variant, i))
                assert cluster_split(spec, dtype) == (k or 1)
                assert stage_form(spec, dtype) == (
                    f"{prefix}, cluster of {k}" if k else prefix)
                smem = lib.ssyt_os_stage_smem_bytes(*args, bf16, k or 1)
                assert 0 < smem <= _build.MAX_SMEM
                if k:  # one block a crop does not fit
                    assert lib.ssyt_os_stage_smem_bytes(*args, bf16, 1) == -1
                    if bf16 or (variant, i) not in shared:
                        assert 2 * (smem + 1024) <= 228 * 1024


_CLUSTER_CASES = [
    (torch.bfloat16, "osnet_x0_5", 0), (torch.bfloat16, "osnet_x0_75", 0),
    (torch.bfloat16, "osnet_x1_0", 0), (torch.bfloat16, "osnet_x1_0", 1),
    (torch.float32, "osnet_x0_25", 0), (torch.float32, "osnet_x0_5", 0),
    (torch.float32, "osnet_x0_5", 1), (torch.float32, "osnet_x0_75", 0),
    (torch.float32, "osnet_x0_75", 1), (torch.float32, "osnet_x1_0", 0),
    (torch.float32, "osnet_x1_0", 1)]


@pytest.mark.parametrize("dtype,variant,i", _CLUSTER_CASES,
                         ids=[f"{str(d)[6:]}-{v[6:]}-stage{i + 2}"
                              for d, v, i in _CLUSTER_CASES])
def test_os_stage_cluster_form(dev, dtype, variant, i):
    """The stages K6 splits over a cluster of blocks a crop (four in
    bfloat16, seven in float32), at G = 96: within the bar of the plain
    version, two launches bit-identical, and at G = 1 and 7 the same
    crops' output of the G = 96 launch, bit for bit (a crop's bands never
    see another crop)."""
    cfg = OsnetConfig(variant=variant)
    model = osnet_from_state_dict(
        init_osnet(cfg, torch.Generator().manual_seed(1)), cfg)
    spec = stage_specs(cfg.channels)[i]
    assert ", cluster of" in stage_form(spec, dtype)
    w = stage_weights(model, i, dtype).to(dev)
    x = torch.from_numpy(np.random.default_rng(i).normal(
        0, 1, (96, spec.c_in, spec.h, spec.w)).astype(np.float32)).to(
            dev, dtype)
    full, again = os_stage(x, w, spec), os_stage(x, w, spec)
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    for g in (1, 7):
        assert torch.equal(os_stage(x[:g], w, spec), full[:g])
    _assert_k6_close(full, os_stage_plain(x, w, spec), stage_form(spec, dtype))


def test_os_stage_refuses_stages_outside_the_table(dev):
    """A stage of no released OSNet width at 128x64 crops raises, naming
    the table, on the card (the CPU runs the plain version of any)."""
    import dataclasses

    cfg = OsnetConfig()
    model = osnet_from_state_dict(
        init_osnet(cfg, torch.Generator().manual_seed(0)), cfg)
    spec = stage_specs(cfg.channels)[1]
    w = stage_weights(model, 1, torch.float32).to(dev)
    odd = dataclasses.replace(spec, h=spec.h * 2)  # a 256x64 crop's stage 3
    x = torch.zeros((2, odd.c_in, odd.h, odd.w), device=dev)
    with pytest.raises(ValueError, match="x0_25, x0_5, x0_75 and x1_0"):
        os_stage(x, w, odd)


def test_strongsort_fused_pipeline_card_equals_cpu(dev):
    """StrongSORT with the fused OSNet stages: K6 on the card against its
    plain version on the CPU, float32, as the unfused pipeline test."""
    before = os_stage.launches
    test_strongsort_pipeline_card_equals_cpu(dev, reid_fused=True)
    n = os_stage.launches - before  # three per embed on the card
    assert n > 0 and n % 3 == 0


def test_strongsort_x1_0_fused_pipeline_card_equals_cpu(dev):
    """The fused OSNet at x1_0 width (seeded random weights): K6's float32
    form (3xTF32) on the card against its plain version on the CPU."""
    before = os_stage.launches
    test_strongsort_pipeline_card_equals_cpu(dev, reid_fused=True,
                                            reid_weights="osnet_x1_0")
    n = os_stage.launches - before
    assert n > 0 and n % 3 == 0


def test_cadence_two_card_equals_cpu(dev):
    """A StrongSORT BatchedPipeline with reid_cadence=2 on the card and on
    the CPU: the same masks, ids and boxes within 1e-3 px."""
    rng = np.random.default_rng(8)
    frames = (rng.uniform(0, 0.3, (6, 2, 320, 320, 3)) * 255).astype(np.uint8)
    for t in range(6):
        frames[t, :, 60 + 3 * t:160 + 3 * t, 80:150] = 210
        frames[t, :, 170:250, 200 - 2 * t:270 - 2 * t] = 140
    outs, masks = {}, {}
    for device in ("cpu", "cuda"):
        pipe = Pipeline(
            DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16),
            tracker=StrongSortConfig(gmc_method="none"), track_slots=16,
            tracker_max_dets=16, reid_weights=OSNET, reid_cadence=2,
            device=device,
        )
        bp = BatchedPipeline(pipe, 2, (320, 320))
        outs[device], masks[device] = [], []
        for f in frames:
            outs[device].append(bp.step(f))
            masks[device].append(bp.last_embed_mask)
    np.testing.assert_array_equal(np.stack(masks["cuda"]),
                                  np.stack(masks["cpu"]))
    assert (np.stack(masks["cuda"]).sum(1) == 1).all()
    rows = 0
    for a_t, b_t in zip(outs["cpu"], outs["cuda"]):
        for a, b in zip(a_t, b_t):
            assert len(a) == len(b)
            np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3)
            np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
            rows += len(a)
    assert rows > 0


@pytest.mark.parametrize("shape", [(80, 80, 32, 32, 3), (40, 40, 64, 64, 3),
                                   (40, 40, 192, 128, 1), (80, 80, 64, 51, 3),
                                   (37, 53, 16, 20, 3), (8, 200, 64, 64, 1),
                                   (16, 24, 8, 200, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_conv_act_kernel_equals_plain(dev, shape, dtype, layout):
    h, w, c_in, c_out, k = shape
    rng = np.random.default_rng(c_in + c_out)
    x = torch.from_numpy(rng.normal(0, 1, (3, c_in, h, w)).astype(np.float32))
    x = x.to(dev, dtype)
    if layout == "nhwc":
        x = x.permute(0, 2, 3, 1)  # a strided view: K7 reads it in place
    wt = torch.from_numpy((rng.normal(0, 1, (k * k * c_in, c_out))
                           * (2.0 / (k * k * c_in)) ** 0.5).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(0, 0.3, c_out).astype(np.float32)).to(dev)
    for act in (True, False):
        want = conv_act_plain(x, wt, b, k=k, act=act, layout=layout).float()
        scale = want.abs().clamp(min=1.0)
        tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
        forms = FORMS if dtype == torch.bfloat16 else ("taps", "im2col")
        if dtype == torch.float32:
            with pytest.raises(ValueError, match="bfloat16"):
                conv_act_kernel(x, wt, b, k=k, act=act, layout=layout,
                                form="mma")
        for form in forms:
            before = conv_act.launches
            got = conv_act_kernel(x, wt, b, k=k, act=act, layout=layout, form=form)
            again = conv_act_kernel(x, wt, b, k=k, act=act, layout=layout,
                                    form=form)
            assert conv_act.launches == before + 2
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == dtype
            assert torch.equal(got, again)
            err = float(((got.float() - want) / scale).abs().max())
            assert err <= tol, (form, act, err)


def test_conv_act_grad_on_the_card(dev):
    """Forward K7 (taps in float32, mma in bfloat16), backward the plain
    formulation's autograd, card against CPU. In bfloat16 the card's
    forward may differ from the CPU's by one bf16 unit, and the loss's
    gradient 2y with it; the bf16 input gradient is a cancelling sum
    rounded to bf16, so the gradients agree within one bf16 unit at 1.0
    of the largest gradient."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 40, 40, 32)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(0, 0.1, (9 * 32, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.3, 16).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        grads = {}
        for device in ("cpu", "cuda"):
            leaves = [x.detach().to(device, dtype).requires_grad_(),
                      *(t.detach().to(device).requires_grad_() for t in (wt, b))]
            before = conv_act.launches
            (conv_act(*leaves, k=3, act=True).float() ** 2).sum().backward()
            assert conv_act.launches == before + (device == "cuda")
            grads[device] = [t.grad.float().cpu() for t in leaves]
        for a, c in zip(grads["cpu"], grads["cuda"]):
            if dtype == torch.float32:
                np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-4,
                                           atol=1e-3)
            else:
                scale = max(1.0, float(a.abs().max()))
                np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=0,
                                           atol=2.0 ** -7 * scale)


@pytest.mark.parametrize("asset", ["yolov8n_seg_synth160", "yolo11n_pose_synth160"])
@pytest.mark.parametrize("conv_kernel", [False, True])
def test_task_pipeline_card_equals_cpu(dev, asset, conv_kernel):
    """The trained task checkpoints through BatchedPipeline, card against
    CPU, with the K7 route off and on: rows, ids, boxes and keypoints
    within 1e-3 px, mask polygons equal."""
    rng = np.random.default_rng(9)
    frames = (rng.uniform(0, 0.3, (5, 2, 320, 320, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:320, 0:320]
    for t in range(5):
        for s in range(2):
            ell = ((xx - 100 - 4 * t - 90 * s) / 48) ** 2 + (
                (yy - 150) / 34) ** 2 <= 1
            frames[t, s][ell] = 209
    outs = {}
    before = conv_act.launches
    for device in ("cpu", "cuda"):
        pipe = Pipeline(
            DetectorConfig(weights=os.path.join(ASSETS, asset + ".npz"),
                           imgsz=160, half=False, max_det=8),
            tracker="bytetrack.yaml", track_slots=8, tracker_max_dets=8,
            conv_kernel=conv_kernel, device=device,
        )
        bp = BatchedPipeline(pipe, 2, (320, 320))
        outs[device] = [bp.step(f) for f in frames]
    assert (conv_act.launches > before) == conv_kernel
    rows = 0
    for a_t, b_t in zip(outs["cpu"], outs["cuda"]):
        for a, b in zip(a_t, b_t):
            assert len(a) == len(b)
            np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy, atol=1e-3)
            np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
            if a.keypoints is not None:
                np.testing.assert_allclose(b.keypoints.xy, a.keypoints.xy,
                                           atol=1e-3)
            if a.masks is not None:
                for pa, pb in zip(a.masks.xy, b.masks.xy):
                    np.testing.assert_array_equal(pb, pa)
            rows += len(a)
    assert rows > 0


# -- the asynchronous API -------------------------------------------------

ASYNC_T = 5


def _async_case(name, dev):
    """-> (BatchedPipeline of 2 streams on the card, frames (ASYNC_T, 2,
    H, W, 3), warps (ASYNC_T, 2, 2, 3) or None): BoT-SORT with host
    warps, without GMC, or with flow_tpu, StrongSORT + the trained OSNet, or the
    trained pose / segment checkpoints with ByteTrack; float32."""
    rng = np.random.default_rng(11)
    bg = (rng.uniform(0, 0.3, (2, 320, 320, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:320, 0:320]
    frames = np.empty((ASYNC_T, 2, 320, 320, 3), np.uint8)
    for t in range(ASYNC_T):
        for s in range(2):
            f = np.roll(bg[s], (-2 * t, 3 * t), axis=(0, 1))
            if name in ("pose", "seg"):
                f[((xx - 100 - 4 * t - 90 * s) / 48) ** 2
                  + ((yy - 150) / 34) ** 2 <= 1] = 209
            else:
                f[60 + 3 * t:160 + 3 * t, 80:150] = 210
                f[170:250, 200 - 2 * t:270 - 2 * t] = 140
            frames[t, s] = f
    warps = None
    kw = dict(track_slots=16, tracker_max_dets=16, device=dev)
    det = DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16)
    if name in ("pose", "seg"):
        asset = "yolo11n_pose_synth160" if name == "pose" else "yolov8n_seg_synth160"
        det = DetectorConfig(weights=os.path.join(ASSETS, asset + ".npz"),
                             imgsz=160, half=False, max_det=8)
        kw.update(track_slots=8, tracker_max_dets=8, tracker="bytetrack.yaml")
    elif name == "strongsort":
        kw.update(tracker=StrongSortConfig(gmc_method="none"),
                  reid_weights=OSNET)
    elif name.startswith("int8"):
        det = DetectorConfig(weights=CKPT, imgsz=160, half=False, max_det=16,
                             quant="int8")
        kw.update(tracker=ByteTrackConfig(tracker_type="botsort",
                                          gmc_method="none"))
    else:
        gmc = {"flow_tpu": "flow_tpu", "botsort_none": "none"}.get(
            name, "sparseOptFlow")
        kw.update(tracker=ByteTrackConfig(tracker_type="botsort",
                                          gmc_method=gmc))
        if name == "botsort_warps":
            warps = np.tile(np.eye(2, 3, dtype=np.float32),
                            (ASYNC_T, 2, 1, 1))
            warps[..., 2] = (3.0, -2.0)
    return BatchedPipeline(Pipeline(det, **kw), 2, (320, 320)), frames, warps


def _warp(warps, t):
    return None if warps is None else warps[t]


def _assert_bitwise(want, got, what):
    assert len(got) == len(want), what
    for name in ("xyxy", "conf", "cls", "id"):
        np.testing.assert_array_equal(getattr(got.boxes, name),
                                      getattr(want.boxes, name), err_msg=what)
    for name in ("keypoints", "masks"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), what
        if a is not None:
            np.testing.assert_array_equal(b.data, a.data, err_msg=what)


@pytest.mark.parametrize("name", ["botsort_warps", "botsort_host",
                                  "flow_tpu", "strongsort", "pose", "seg",
                                  "int8_dynamic", "int8_static"])
def test_step_async_issues_no_stream_sync(dev, name):
    """After two ticks (kernels built, per-shape constants uploaded), the
    overlapped loop (step_async t, materialize t - 1) runs under
    torch.cuda.set_sync_debug_mode("error") without raising: no
    synchronizing op, no pageable copy. The host waits only on events:
    each handle's own, and on StrongSORT once per tick in
    Pipeline._wait_counts, the ReID count read, counted here. Also the
    host sparseOptFlow warps (uploaded through pinned memory) and the
    int8 detector with its dynamic scales (device reductions) and with
    calibrated ones."""
    bp, frames, warps = _async_case(name, dev)
    pipe = bp.pipeline
    if name == "int8_static":
        assert pipe.calibrate_int8(list(frames[0])) == 32
        bp.refresh_steps()
    for t in range(2):
        bp.step(frames[t], _warp(warps, t))
    waits, rows = pipe.count_waits, 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.zeros(1, device=dev).cpu()  # the mode is on
        pending = None
        for t in range(2, ASYNC_T):
            handle = bp.step_async(frames[t], _warp(warps, t))
            if pending is not None:
                rows += sum(map(len, bp.materialize(pending)))
            pending = handle
        rows += sum(map(len, bp.materialize(pending)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pipe.count_waits - waits == (ASYNC_T - 2) * (name == "strongsort")
    assert rows > 0


@pytest.mark.parametrize("name", ["pose", "seg", "strongsort"])
def test_five_pending_ticks_through_a_ring_of_two(dev, name, monkeypatch):
    """Five step_async calls on distinct frames before any materialize,
    through a ring of two slots, materialized newest first: the five
    step results bit for bit (boxes, ids, keypoints, masks)."""
    from strongsort_yolo_tpu_torch.utils.transfer import RING_DEPTH

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    assert RING_DEPTH == 2
    bp, frames, warps = _async_case(name, dev)
    want = [bp.step(frames[t]) for t in range(ASYNC_T)]
    queued = BatchedPipeline(bp.pipeline, 2, (320, 320))
    handles = [queued.step_async(frames[t]) for t in range(ASYNC_T)]
    rows = 0
    for t in reversed(range(ASYNC_T)):
        for s, (a, b) in enumerate(zip(want[t], queued.materialize(handles[t]))):
            _assert_bitwise(a, b, f"t={t} s={s}")
            rows += len(b)
    assert rows > 0


def test_materialize_waits_for_its_own_tick_only(dev):
    """The compute stream held by torch.cuda._sleep between two ticks:
    materialize(t - 1), masks gathered and copied on the download stream,
    returns while tick t's event still reports query() == False."""
    bp, frames, _ = _async_case("seg", dev)
    for t in range(3):
        bp.step(frames[t])
    first = bp.step_async(frames[3])
    torch.cuda._sleep(2_000_000_000)  # about a second of the stream
    second = bp.step_async(frames[4])
    results = bp.materialize(first)
    assert not second.query()
    assert sum(len(r.masks) for r in results) > 0
    bp.materialize(second)
    assert second.query()


@pytest.mark.parametrize("name", ["botsort_none", "flow_tpu", "pose", "seg"])
def test_step_async_returns_while_the_stream_is_held(dev, name):
    """The no-sync claim checked without set_sync_debug_mode: after two
    warm ticks the compute stream is held by torch.cuda._sleep (about a
    second) and an event is recorded behind it; step_async of the next
    tick returns while that event is still pending, so it waited for no
    work on the stream (paths a, c, pose and e; a ReID path waits on its
    detection counts by design). The tick's results come after."""
    bp, frames, warps = _async_case(name, dev)
    for t in range(2):
        bp.step(frames[t], _warp(warps, t))
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    held = torch.cuda.Event()
    held.record()
    handle = bp.step_async(frames[2], _warp(warps, 2))
    assert not held.query()
    assert not handle.query()
    rows = sum(map(len, bp.materialize(handle)))
    assert held.query() and rows > 0


def test_app_runs_on_the_card_by_default(dev, tmp_path):
    """app.run without a device builds its pipeline on CUDA: the letterbox
    kernel launches once per frame."""
    from strongsort_yolo_tpu_torch.app import AppConfig, run
    from strongsort_yolo_tpu_torch.media.video import SyntheticDetSource

    letterbox_u8.launches = 0
    stats = run(AppConfig(track=True, weights=CKPT, imgsz=160, max_det=16,
                          half=False, tracker="bytetrack.yaml", save=False,
                          output_dir=str(tmp_path)),
                sources=[SyntheticDetSource(num_frames=4, size=(320, 320))])
    assert stats[0].frames == 4 and stats[0].failed is None
    assert letterbox_u8.launches == 4


def test_checkpoint_moves_between_card_and_cpu(dev, tmp_path):
    """A state saved from the card restores on the CPU and the other way
    round, field for field."""
    from strongsort_yolo_tpu_torch.track.state import TrackState, init_track_state
    from strongsort_yolo_tpu_torch.utils.checkpoint import restore_state, save_state

    gen = torch.Generator().manual_seed(0)
    state = TrackState(*((torch.rand(f.shape, generator=gen) * 50).to(f.dtype)
                         for f in init_track_state(1, 16, feat_dim=8)))
    for src, dst in ((dev, "cpu"), ("cpu", dev)):
        path = str(tmp_path / f"{src}_ckpt")
        save_state(path, TrackState(*(f.to(src) for f in state)), 9)
        got, frame = restore_state(path, init_track_state(1, 16, dst,
                                                          feat_dim=8))
        assert frame == 9
        for a, b in zip(state, got):
            assert b.device.type == torch.device(dst).type
            assert torch.equal(b.cpu(), a)


def test_reset_stream_and_sync_between_pending_ticks_on_the_card(dev):
    """reset_stream and sync while ticks are pending give the results of
    the synchronous sequence, bit for bit."""
    bp, frames, warps = _async_case("botsort_warps", dev)
    want = []
    for t in range(ASYNC_T):
        if t == 3:
            bp.reset_stream(1)
        want.append(bp.step(frames[t], warps[t]))
    queued = BatchedPipeline(bp.pipeline, 2, (320, 320))
    handles = []
    for t in range(ASYNC_T):
        if t == 3:
            queued.reset_stream(1)
            queued.sync()
        handles.append(queued.step_async(frames[t], warps[t]))
    for t in reversed(range(ASYNC_T)):
        for s, (a, b) in enumerate(zip(want[t], queued.materialize(handles[t]))):
            _assert_bitwise(a, b, f"t={t} s={s}")


@pytest.mark.parametrize("name", ["yolov5s", "yolov7"])
def test_v5_v7_pipeline_runs_on_the_card_by_default(dev, name):
    """Pipeline(weights="yolov5s" / "yolov7") without a device builds on
    CUDA and runs one tick, its NMS keep mask through K2."""
    pipe = Pipeline(DetectorConfig(weights=name, imgsz=640),
                    tracker="bytetrack.yaml")
    assert pipe.device.type == "cuda"
    assert next(pipe.model.parameters()).is_cuda
    frame = np.random.default_rng(0).integers(0, 255, (1080, 1920, 3), np.uint8)
    nms_keep.launches = 0
    r = pipe.track(frame)
    assert nms_keep.launches > 0
    assert np.isfinite(r.boxes.xyxy).all()


def test_aflink_logits_card_equal_cpu(dev):
    """The shipped AFLink on fresh pairs (tests/test_aflink.py's draw): the
    card's logits within 1e-5 x max(1, |logit|) of the CPU's (float32,
    TF32 off in the forward), the same link decisions."""
    from strongsort_yolo_tpu_torch.tools.train_aflink import (
        make_pairs, make_trajectories,
    )
    from strongsort_yolo_tpu_torch.track import aflink

    rng = np.random.default_rng(1234)
    fa, ma, fb, mb, y = make_pairs(rng, make_trajectories(rng, 30), 400, 400)
    path = aflink.default_checkpoint()
    torch.backends.cudnn.allow_tf32 = True  # the forward must turn it off
    try:
        got = aflink.aflink_logits(aflink.load_aflink(path, dev), fa, ma, fb, mb)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = aflink.aflink_logits(aflink.load_aflink(path, "cpu"), fa, ma, fb, mb)
    assert np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))) <= 1e-5
    assert np.array_equal(got > 0, want > 0)
    assert np.mean((got > 0) == (y > 0.5)) >= 0.95


@pytest.mark.parametrize("flags", [[], ["--strongsort-pp", "--aflink"]])
@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "strongsort.yaml"])
def test_eval_mot_public_card_equals_cpu(dev, tracker, flags, capsys):
    """eval_mot --public on tests/fixtures/MOT-synth01: the card's JSON line
    equals the CPU's, K3 launched on every frame."""
    from strongsort_yolo_tpu_torch.tools import eval_mot

    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "MOT-synth01")
    argv = [fixture, "--public", "--tracker", tracker, *flags]
    auction.launches = 0
    assert eval_mot.main(argv + ["--device", "cuda"]) == 0
    launches = auction.launches
    card = capsys.readouterr().out
    assert eval_mot.main(argv + ["--device", "cpu"]) == 0
    assert card == capsys.readouterr().out
    assert launches >= 2 * 300


def test_link_tracklets_aflink_card_equals_cpu(dev):
    """The learned linker's cost matrix on cut trajectories, card against
    CPU within 1e-5, and link_tracklets makes the same merges."""
    from strongsort_yolo_tpu_torch.tools.train_aflink import make_trajectories
    from strongsort_yolo_tpu_torch.track import aflink
    from strongsort_yolo_tpu_torch.track.postprocess import (
        link_tracklets, records_to_tracks,
    )

    recs = []
    for k, tr in enumerate(make_trajectories(np.random.default_rng(77), 8,
                                             t_len=120)):
        cut, gap = 50 + 3 * k, 4 + k
        recs += [(int(r[0]), 2 * k + 1, *r[1:5]) for r in tr[:cut]]
        recs += [(int(r[0]), 2 * k + 2, *r[1:5]) for r in tr[cut + gap:]]
    tracks = records_to_tracks(recs)
    path = aflink.default_checkpoint()
    fns = {d: aflink.make_cost_fn(aflink.load_aflink(path, d))
           for d in (dev, "cpu")}
    ordered = [tracks[t] for t in sorted(tracks)]
    assert np.max(np.abs(fns[dev](ordered) - fns["cpu"](ordered))) <= 1e-5
    got, want = (link_tracklets(tracks, cost_fn=fns[d], link_thresh=0.5)
                 for d in (dev, "cpu"))
    assert list(got) == list(want) == [2 * k + 1 for k in range(8)]
    assert all(np.array_equal(got[t], want[t]) for t in got)


def test_train_step_card_equals_cpu(dev):
    """One make_train_step step from the trained asset (imgsz 64, batch 2)
    on the card and on the CPU: loss within 1e-4 relative, num_fg equal
    and above 0, every tensor's gradient (the BN statistics included)
    within 1e-4 of the CPU's norm of it, and the next loss within 1e-4."""
    from strongsort_yolo_tpu_torch.models import porting
    from strongsort_yolo_tpu_torch.tools.train import synthetic_batch
    from strongsort_yolo_tpu_torch.train.trainer import (
        make_optimizer, make_train_step, train_state,
    )

    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, 2, 64) for _ in range(2)]
    tree, cfg, _ = porting.load_npz_checkpoint(CKPT)
    tx = make_optimizer(1e-3)
    step = make_train_step(cfg, 64, tx)
    out = {}
    for d in (dev, torch.device("cpu")):
        model = porting.model_from_state_dict(porting.params_from_jax(tree, cfg),
                                              cfg).to(d)
        state = train_state(model, tx)
        state, m0 = step(state, *batches[0])
        grads = {k: t.grad.cpu() for k, t in [*model.named_parameters(),
                                             *model.named_buffers()]}
        _, m1 = step(state, *batches[1])
        out[d.type] = (float(m0["loss"]), float(m0["num_fg"]), grads,
                       float(m1["loss"]))
    (lc, fc, gc, nc), (l0, f0, g0, n0) = out["cuda"], out["cpu"]
    assert fc == f0 > 0
    assert abs(lc - l0) <= 1e-4 * l0 and abs(nc - n0) <= 1e-4 * n0
    assert any(k.endswith("bn_var") for k in g0)
    for k, g in g0.items():
        assert float((gc[k] - g).norm()) <= 1e-4 * float(g.norm()), k


def test_train_steps_on_the_card_repeat_bit_for_bit(dev):
    """Three steps from a seeded init, twice: equal weights and BN
    statistics bit for bit (cuDNN's deterministic algorithms,
    train.trainer.exact_step)."""
    from strongsort_yolo_tpu_torch.models.yolo import YoloConfig
    from strongsort_yolo_tpu_torch.tools.train import synthetic_batch
    from strongsort_yolo_tpu_torch.train.trainer import (
        init_train_state, make_optimizer, make_train_step,
    )

    cfg = YoloConfig(nc=3)
    tx = make_optimizer(1e-3)
    step = make_train_step(cfg, 96, tx)
    finals = []
    for _ in range(2):
        state = init_train_state(0, cfg, tx, dev)
        rng = np.random.default_rng(0)
        for _ in range(3):
            state, _ = step(state, *synthetic_batch(rng, 4, 96))
        finals.append({k: v.detach().clone() for k, v in
                       state.model.state_dict().items()})
    assert all(torch.equal(finals[0][k], finals[1][k]) for k in finals[0])


@pytest.mark.parametrize("shape", sorted([(40, 40, 192, 128, 1),
                                          (80, 80, 32, 32, 3)]))
def test_conv_act_gradients_on_the_card_equal_plain(dev, shape):
    """K7's autograd Function on the card (forward K7, backward the plain
    formulation): dx, dw, db within 1e-5 x max(1, |g|) of the plain
    version's autograd on the same card."""
    from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import conv_act_nchw

    h, w, c_in, c_out, k = shape
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(0, 1, (2, c_in, h, w)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(0, 1, (k * k * c_in, c_out))
                           * (2.0 / (k * k * c_in)) ** 0.5).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.3, c_out).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 1, (2, c_out, h, w)).astype(np.float32))
    grads = []
    before = conv_act.launches
    for fn in (conv_act_nchw, lambda *a, **kw: conv_act_plain(
            *a, layout="nchw", **kw)):
        leaves = [t.to(dev).requires_grad_() for t in (x, wt, b)]
        (fn(*leaves, k=k, act=True) * r.to(dev)).sum().backward()
        grads.append([t.grad for t in leaves])
    assert conv_act.launches == before + 1
    for g, p in zip(*grads):
        assert float(((g - p).abs() / p.abs().clamp(min=1.0)).max()) <= 1e-5


def test_unfused_osnet_on_the_card_equals_the_folded_one(dev):
    """The trainer's unfused OSNet (the shipped checkpoint) on the card
    against the folded model on the card and the unfused one on the CPU,
    float32 with TF32 off, within 1e-5."""
    from strongsort_yolo_tpu_torch.models.porting import (
        load_osnet_npz, osnet_params_from_jax,
    )
    from strongsort_yolo_tpu_torch.models.osnet import OSNet

    tree, cfg = load_osnet_npz(OSNET)
    sd = osnet_params_from_jax(tree, cfg)
    unfused = OSNet(cfg, fused=False)
    unfused.load_state_dict(sd)
    folded = osnet_from_state_dict(sd, cfg).to(dev)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (16, 3, 128, 64)).astype(np.float32))
    with torch.no_grad():
        want = unfused(x)
        got = unfused.to(dev)(x.to(dev))
        ref = folded(x.to(dev))
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    assert float((got - ref).abs().max()) <= 1e-5


# -- K8: the int8 conv ------------------------------------------------------

# (n, c_in, h, w, c_out, k, stride, groups, act): yolov8n's classes at 640
# (1x1 and 3x3 stride 1, 3x3 stride 2, C_in 16 padded to 32), yolo11n-pose's
# depthwise pe conv and its act=False 1x1s, a ragged C_out; and the edges
# of the tensor-core form's tiles: 64-pixel tiles across three 20 x 20
# images, C_out 256 (two or more N tiles), stride 2 on a 41 x 41 plane
# (ragged output rows, no 16-byte stores), a 1x1 conv with C_in 512; the
# depthwise form at S=8 and on a plane dw_plan cuts into bands (k 5,
# stride 2, a ragged last band)
S8_CASES = [
    (2, 16, 160, 160, 32, 1, 1, 1, True),
    (2, 64, 80, 80, 64, 3, 1, 1, True),
    (2, 64, 80, 80, 128, 3, 2, 1, True),
    (2, 128, 20, 20, 128, 3, 1, 128, False),
    (2, 128, 20, 20, 256, 1, 1, 1, False),
    (1, 48, 33, 17, 51, 3, 1, 1, True),
    (3, 128, 20, 20, 128, 3, 1, 1, True),
    (2, 128, 40, 40, 256, 3, 2, 1, True),
    (2, 64, 41, 41, 64, 3, 2, 1, True),
    (2, 512, 20, 20, 256, 1, 1, 1, True),
    (8, 128, 20, 20, 128, 3, 1, 128, False),  # the pe conv at S=8
    (1, 16, 96, 96, 16, 5, 2, 16, True),  # depthwise cut into bands
    # yolov7's classes (its planes at 640 are 160, 80, 40 and 20 square;
    # here cut to 20 x 12 up to 160 x 96, whose 64-pixel tiles do not
    # all fill), S=8 where the main path's conv is small: 1x1 with C_in
    # 1024 and 2048 (SPPCSPC), 3x3 512 -> 1024 (K = 4608), C_out 1024,
    # the widest plane, and a 3x3 stride-2 conv on an odd plane
    (8, 1024, 20, 12, 512, 1, 1, 1, True),
    (8, 2048, 20, 12, 512, 1, 1, 1, True),
    (8, 512, 20, 12, 1024, 3, 1, 1, True),
    (2, 1024, 40, 24, 1024, 1, 1, 1, True),
    (2, 64, 160, 96, 64, 3, 1, 1, True),
    (2, 256, 41, 39, 256, 3, 2, 1, True),
]


def _s8_case(dev, case, dtype, scale, seed=0):
    n, c_in, h, w, c_out, k, stride, groups, act = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1.5, (n, c_in, h, w)).astype(
        np.float32)).to(dev, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (c_out, c_in // groups, k, k),
                                       dtype=np.int8)).to(dev)
    ws = torch.from_numpy(rng.uniform(1e-4, 2e-3, c_out).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(0, 0.5, c_out).astype(np.float32)).to(dev)
    amax = x.float().abs().amax()
    xs = (torch.clamp_min(amax, 1e-6) / torch.full_like(amax, 127.0)
          if scale == "dynamic" else torch.tensor(np.float32(0.03), device=dev))
    return (x, wq, ws, b, xs), dict(stride=stride, pad=(k - 1) // 2,
                                    groups=groups, act=act)


@pytest.mark.parametrize("scale", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", S8_CASES)
def test_conv_s8_kernel_equals_plain(dev, case, dtype, scale):
    args, kw = _s8_case(dev, case, dtype, scale)
    packed = pack_s8(args[1], kw["groups"])
    sums = conv_s8(*args, **kw, packed=packed, sums=True)
    assert torch.equal(sums, conv_s8_plain(*args, **kw, sums=True))
    got = conv_s8(*args, **kw, packed=packed)
    again = conv_s8(*args, **kw)
    want = conv_s8_plain(*args, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    if not kw["act"]:
        assert torch.equal(got, want)
    else:
        unit = 4 * 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7
        err = ((got.float() - want.float()).abs()
               / want.float().abs().clamp(min=1.0)).max()
        assert float(err) <= unit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", S8_CASES[:6])
def test_conv_s8_codes_equal_plain(dev, case, dtype):
    """K8's quantize pass alone: the codes, channel-minor and zero-padded,
    equal quantize_codes_plain's, also through a channel slice."""
    args, _ = _s8_case(dev, case, dtype, "dynamic")
    x, xs = args[0], args[4]
    assert torch.equal(quantize_codes(x, xs), quantize_codes_plain(x, xs))
    wide = torch.cat([x, x.flip(1)], 1)[:, :x.shape[1]]
    assert torch.equal(quantize_codes(wide, xs), quantize_codes_plain(x, xs))


def test_conv_s8_reads_strided_input(dev):
    """A channel slice of a wider tensor (C2f's chunk) through its strides."""
    args, kw = _s8_case(dev, S8_CASES[1], torch.bfloat16, "dynamic")
    x, rest = args[0], args[1:]
    wide = torch.cat([x, x.flip(1)], 1)[:, :x.shape[1]]
    assert not wide.is_contiguous()
    assert torch.equal(conv_s8(wide, *rest, **kw),
                       conv_s8_plain(x, *rest, **kw))
