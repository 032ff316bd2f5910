"""The port's detection loss (train/loss.py, ops/boxes.ciou) against the
JAX package's, on the same numpy inputs.

Tolerances: CIoU values and gradients within 1e-6 x max(1, |ref|) (the
same float32 expression on both sides; atan and the divisions may round
apart by an ulp); the assigner's ``assigned`` and ``fg`` equal and its
target scores within 1e-6; ``detection_loss`` on the outputs of the
three trained assets at imgsz 64 (the port's forward, fed to both
sides as numpy) within 1e-5 relative for the loss and each metric, and
its gradient with respect to every output within 1e-5 x max(1, |g|).
The JAX side runs jitted. A random init at imgsz <= 160 assigns no
foreground, which would leave CIoU, the DFL and the task terms out, so
every case asserts ``num_fg > 0`` and each term above 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops import boxes as jboxes
from strongsort_yolo_tpu.ops.decode import make_anchors as jmake_anchors
from strongsort_yolo_tpu.tools import train as jtrain
from strongsort_yolo_tpu.train import loss as jloss
from strongsort_yolo_tpu_torch.models import porting as tporting
from strongsort_yolo_tpu_torch.models import yolo as tyolo
from strongsort_yolo_tpu_torch.ops import boxes as tboxes
from strongsort_yolo_tpu_torch.ops.decode import make_anchors
from strongsort_yolo_tpu_torch.train import loss as tloss

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
IMGSZ = 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scaled_err(got, want) -> float:
    """Largest |got - want| / max(1, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def seeded_box_pairs(seed: int = 0, n: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Random overlapping pairs, then disjoint, nested, identical, shared-
    edge and degenerate (zero width, zero height, a point) pairs."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    a = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], 1)
    b = a + rng.normal(0, 10, (n, 4))
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] + 1.0)
    special_a = [
        (0, 0, 10, 10), (0, 0, 10, 10), (0, 0, 40, 40), (5, 5, 25, 35),
        (0, 0, 10, 10), (10, 10, 20, 30), (10, 10, 10, 30), (5, 5, 25, 5),
        (7, 7, 7, 7),
    ]
    special_b = [
        (20, 20, 30, 35),  # disjoint
        (50, 0, 60, 10),  # disjoint on a row
        (10, 5, 20, 25),  # nested
        (5, 5, 25, 35),  # identical
        (10, 0, 20, 10),  # a shared edge
        (12, 12, 18, 24),  # nested, the other way
        (10, 10, 20, 30),  # zero width
        (0, 0, 30, 10),  # zero height
        (5, 5, 9, 9),  # a point
    ]
    a = np.concatenate([a, np.asarray(special_a, np.float64)])
    b = np.concatenate([b, np.asarray(special_b, np.float64)])
    return a.astype(np.float32), b.astype(np.float32)


def test_ciou_values_and_gradients_equal_jax():
    a, b = seeded_box_pairs()

    def jsum(a, b):
        c = jboxes.ciou(a, b)
        return jnp.sum(c * jnp.arange(1, c.shape[0] + 1)), c

    (_, jc), (jga, jgb) = jax.jit(jax.value_and_grad(
        jsum, argnums=(0, 1), has_aux=True))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tc = tboxes.ciou(ta, tb)
    (tc * torch.arange(1, tc.shape[0] + 1)).sum().backward()
    assert np.all(np.isfinite(tc.detach().numpy()))
    assert scaled_err(tc.detach(), jc) <= 1e-6
    assert scaled_err(ta.grad, jga) <= 1e-6
    assert scaled_err(tb.grad, jgb) <= 1e-6
    # the special rows: disjoint below 0, identical 1
    tc = tc.detach()
    assert tc[64] < 0 and tc[65] < 0 and abs(float(tc[67]) - 1.0) < 1e-6


def _anchors():
    hw = tyolo.feat_hw((IMGSZ, IMGSZ))
    return jmake_anchors(hw, (8, 16, 32)), make_anchors(hw, (8, 16, 32))


def _assign_both(scores, boxes, gt_boxes, gt_cls, gt_valid):
    """JAX's per-image _assign (jitted, vmapped) and the port's batched
    one on the same inputs -> ((assigned, fg, t), (assigned, fg, t))."""
    (ja, js), (ta, ts) = _anchors()
    jfn = jax.jit(jax.vmap(lambda s, b, g, c, v: jloss._assign(
        s, b, ja * js, g, c, v)))
    want = jax.device_get(jfn(scores, boxes, gt_boxes, gt_cls, gt_valid))
    got = tloss._assign(*(torch.from_numpy(x) for x in (
        scores, boxes)), ta * ts, *(torch.from_numpy(x) for x in (
            gt_boxes, gt_cls, gt_valid)))
    return want, tuple(t.numpy() for t in got)


def _check_assign(want, got):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert np.max(np.abs(got[2] - want[2])) <= 1e-6


def test_assign_equals_jax_on_seeded_predictions():
    (_, _), (ta, ts) = _anchors()
    px = (ta * ts).numpy()
    a = px.shape[0]
    rng = np.random.default_rng(3)
    _, tg = jtrain.synthetic_batch(rng, 3, IMGSZ)
    scores = rng.uniform(0, 1, (3, a, 3)).astype(np.float32)
    half = rng.uniform(4, 24, (3, a, 2)).astype(np.float32)
    boxes = np.concatenate([px - half, px + half], -1)
    want, got = _assign_both(scores, boxes, *(np.array(tg[k]) for k in (
        "boxes", "cls", "valid")))
    assert want[1].sum() > 0
    _check_assign(want, got)


def test_assign_breaks_ties_by_the_lower_index():
    """Equal aligns for every anchor inside a gt (same score, every box the
    gt box): top-k takes the lowest indices, as jax.lax.top_k does; a gt
    claims an anchor another gt also aligns with equally by its index."""
    (_, _), (ta, ts) = _anchors()
    a = ta.shape[0]
    gt = np.asarray([[[0, 0, 48, 48], [8, 8, 56, 56]]], np.float32)
    boxes = np.broadcast_to(gt[:, :1], (1, a, 4)).copy()
    scores = np.full((1, a, 2), 0.5, np.float32)
    want, got = _assign_both(scores, boxes, gt, np.asarray([[1, 1]], np.int32),
                             np.ones((1, 2), bool))
    assert want[1].sum() > 10  # more inside anchors than top-k takes
    _check_assign(want, got)


def test_dfl_loss_values_and_gradients_equal_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (50, 4, 16)).astype(np.float32)
    target = rng.uniform(-1, 16, (50, 4)).astype(np.float32)  # clipped both ends
    weights = rng.uniform(0, 1, 50).astype(np.float32)

    def jf(x):
        d = jloss._dfl_loss(x, jnp.asarray(target), 16)
        return jnp.sum(d * weights), d

    (_, jd), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    d = tloss._dfl_loss(x, torch.from_numpy(target), 16)
    (d * torch.from_numpy(weights)).sum().backward()
    assert scaled_err(d.detach(), jd) <= 1e-6
    assert scaled_err(x.grad, jg) <= 1e-6


CASES = {
    "yolov8n_synth160": (jtrain.synthetic_batch, ()),
    "yolov8n_seg_synth160": (jtrain.synthetic_batch_seg, ("seg_loss",)),
    "yolov8n_pose_synth160": (jtrain.synthetic_batch_pose,
                              ("kpt_loss", "kobj_loss")),
}


@pytest.mark.parametrize("asset", list(CASES))
def test_detection_loss_equals_jax_on_trained_outputs(asset):
    gen, extra = CASES[asset]
    tree, cfg, _ = tporting.load_npz_checkpoint(
        os.path.join(ASSETS, asset + ".npz"))
    model = tporting.model_from_state_dict(
        tporting.params_from_jax(tree, cfg), cfg)
    kw = {"n_kpt": cfg.kpt[0]} if cfg.task == "pose" else {}
    imgs, tg = gen(np.random.default_rng(0), 2, IMGSZ, **kw)
    tg = {k: np.array(v) for k, v in tg.items()}
    with torch.no_grad():
        out = tyolo.model_apply(model, torch.from_numpy(np.array(imgs))
                                .permute(0, 3, 1, 2))
    out = {k: v.numpy() for k, v in out.items()}
    (ja, js), (ta, ts) = _anchors()

    def jf(o):
        return jloss.detection_loss(
            o, {k: jnp.asarray(v) for k, v in tg.items()}, ja, js, nc=cfg.nc)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        {k: jnp.asarray(v) for k, v in out.items()})
    to = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    tl, tm = tloss.detection_loss(
        to, {k: torch.from_numpy(v) for k, v in tg.items()}, ta, ts, nc=cfg.nc)
    tl.backward()
    assert set(tm) == set(jm)
    assert float(tm["num_fg"]) == float(jm["num_fg"]) > 0
    for k in ("loss", "cls_loss", "box_loss", "dfl_loss", *extra):
        assert float(jm[k]) > 0, k
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    for k in out:
        assert scaled_err(to[k].grad, jg[k]) <= 1e-5, k
