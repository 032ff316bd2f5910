"""K2's plain version and the port's nms_from_logits against the TPU NMS
kernel (interpret mode), the JAX fixpoint, and the JAX nms_from_logits.

Keep masks are compared bit for bit (same IoU expression, same
threshold). For nms_from_logits the selected rows (anchor index, class,
validity, count) must be identical; boxes and scores go through
softmax/sigmoid, whose float32 implementations differ in the last bits
between XLA and PyTorch, so they agree within rtol 1e-5 / atol 1e-4 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops import nms as jnms
from strongsort_yolo_tpu.ops.boxes import box_iou as jbox_iou
from strongsort_yolo_tpu.ops.decode import make_anchors
from strongsort_yolo_tpu.ops.pallas.nms_kernel import pallas_nms_keep
from strongsort_yolo_tpu_torch.ops import decode as tdecode
from strongsort_yolo_tpu_torch.ops import nms as tnms
from strongsort_yolo_tpu_torch.ops.cuda.nms_kernel import nms_keep, nms_keep_plain

FEAT = [(20, 20), (10, 10), (5, 5)]  # imgsz 160
STRIDES = (8, 16, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cands(rng, k, kind):
    if kind == "dense":
        base = np.array([100.0, 100.0, 200.0, 200.0])
        boxes = base[None] + rng.uniform(-8, 8, (k, 4))
        conf = np.linspace(0.95, 0.31, k)
    else:
        if kind == "clusters":
            centers = rng.uniform(50, 600, (8, 2))
            idx = rng.integers(0, 8, k)
            cx = centers[idx, 0] + rng.normal(0, 15, k)
            cy = centers[idx, 1] + rng.normal(0, 15, k)
        else:
            cx, cy = rng.uniform(0, 640, k), rng.uniform(0, 640, k)
        w, h = rng.uniform(20, 100, k), rng.uniform(20, 100, k)
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
        conf = np.sort(rng.uniform(0, 1, k))[::-1]
    return boxes.astype(np.float32), conf.astype(np.float32).copy()


@pytest.mark.parametrize("k", [128, 512])
@pytest.mark.parametrize("kind", ["clusters", "uniform", "dense"])
def test_keep_mask_vs_pallas_and_fixpoint(k, kind):
    rng = np.random.default_rng(k + len(kind))
    boxes, conf = _cands(rng, k, kind)
    pallas = np.asarray(
        pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(conf),
                        iou_thres=0.4, conf_thres=0.3, interpret=True)
    )
    fix = np.asarray(jnms._greedy_keep_fixpoint(
        jbox_iou(jnp.asarray(boxes), jnp.asarray(boxes)),
        jnp.asarray(conf >= 0.3), 0.4,
    ))
    got = nms_keep(torch.from_numpy(boxes)[None], torch.from_numpy(conf)[None],
                   iou_thres=0.4, conf_thres=0.3)[0].numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, fix)


def test_keep_mask_batched_equals_per_frame():
    rng = np.random.default_rng(3)
    sets = [_cands(rng, 256, kind) for kind in ("clusters", "uniform", "dense")]
    boxes = torch.from_numpy(np.stack([b for b, _ in sets]))
    conf = torch.from_numpy(np.stack([c for _, c in sets]))
    batched = nms_keep_plain(boxes, conf, iou_thres=0.45, conf_thres=0.3)
    for s in range(3):
        one = nms_keep_plain(boxes[s:s + 1], conf[s:s + 1],
                             iou_thres=0.45, conf_thres=0.3)[0]
        assert torch.equal(batched[s], one)


def _logits(seed, b, nc):
    rng = np.random.default_rng(seed)
    a = sum(h * w for h, w in FEAT)
    box = rng.normal(0, 2, (b, a, 64)).astype(np.float32)
    cls = rng.normal(-4, 2, (b, a, nc)).astype(np.float32)
    # a few objects: clustered high logits on neighbouring anchors
    for s in range(b):
        for _ in range(6):
            i = int(rng.integers(0, a - 3))
            c = int(rng.integers(0, nc))
            cls[s, i:i + 3, c] = rng.uniform(0.5, 4, 3)
    return box, cls


@pytest.mark.parametrize("agnostic,classes,max_det", [
    (False, None, 16), (True, None, 16), (False, (0, 2), 1000),
])
def test_nms_from_logits_vs_jax(agnostic, classes, max_det):
    nc = 5
    box, cls = _logits(7, 3, nc)
    anchors, strides = make_anchors(FEAT, STRIDES)
    filt = None
    if classes is not None:
        filt = np.zeros(nc, bool)
        filt[list(classes)] = True
    kw = dict(conf_thres=0.3, iou_thres=0.4, max_det=max_det,
              agnostic=agnostic)
    got = tnms.nms_from_logits(
        torch.from_numpy(box), torch.from_numpy(cls), feat_dims=FEAT,
        level_strides=STRIDES,
        class_filter=None if filt is None else torch.from_numpy(filt), **kw,
    )
    jfn = jax.jit(lambda b, c: jnms.nms_from_logits(
        b, c, anchors, strides, feat_dims=FEAT, level_strides=STRIDES,
        class_filter=None if filt is None else jnp.asarray(filt), **kw,
    ))
    for s in range(box.shape[0]):
        want = jax.tree.map(np.asarray, jfn(box[s], cls[s]))
        assert int(got.count[s]) == int(want.count) > 0
        np.testing.assert_array_equal(got.valid[s].numpy(), want.valid)
        np.testing.assert_array_equal(got.index[s].numpy(), want.index)
        np.testing.assert_array_equal(got.classes[s].numpy(), want.classes)
        np.testing.assert_allclose(got.scores[s].numpy(), want.scores,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.boxes[s].numpy(), want.boxes,
                                   rtol=1e-5, atol=1e-4)


def test_topk_ties_keep_lower_anchor_first():
    """bf16 logits tie heavily; the candidate order must be lax.top_k's
    (lower anchor first among equals)."""
    a = sum(h * w for h, w in FEAT)
    cls = np.full((1, a, 2), -6.0, np.float32)
    cls[0, [3, 40, 41, 300], 1] = 2.0  # four exact ties
    box = np.zeros((1, a, 64), np.float32)
    got = tnms.nms_from_logits(
        torch.from_numpy(box).to(torch.bfloat16),
        torch.from_numpy(cls).to(torch.bfloat16), feat_dims=FEAT,
        level_strides=STRIDES, max_det=8, agnostic=True, iou_thres=0.99,
    )
    assert got.index[0, :4].tolist() == [3, 40, 41, 300]


def test_anchors_from_indices_equal_anchor_table():
    """The arithmetic anchors the NMS uses equal the port's anchor table,
    which equals the JAX one."""
    anchors, strides = tdecode.make_anchors(FEAT, STRIDES)
    j_anchors, j_strides = make_anchors(FEAT, STRIDES)
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(j_anchors))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(j_strides))
    idx = torch.arange(anchors.shape[0]).reshape(5, -1)
    a, s = tdecode.anchors_from_indices(idx, FEAT, STRIDES)
    assert torch.equal(a, anchors.reshape(5, -1, 2))
    assert torch.equal(s, strides.reshape(5, -1, 1))


def _decoded(rng, b, n, nc):
    """Decoded predictions as the anchor-based heads give them: boxes in
    clusters over a 640 input, per-class confidences mostly below 0.3,
    some rows repeating an earlier row's confidence exactly (ties)."""
    boxes = np.stack([_cands(rng, n, "clusters")[0] for _ in range(b)])
    scores = rng.uniform(0, 0.25, (b, n, nc)).astype(np.float32)
    hot = rng.random((b, n)) < 0.15
    cls = rng.integers(0, nc, (b, n))
    peak = rng.uniform(0.2, 0.95, (b, n)).astype(np.float32)
    bi, ni = np.nonzero(hot)
    scores[bi, ni, cls[bi, ni]] = peak[bi, ni]
    tie = np.nonzero(hot[0])[0][:8]
    scores[0, tie[1::2]] = scores[0, tie[::2]]
    return boxes, scores


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("filtered", [False, True])
def test_non_max_suppression_vs_jax(agnostic, filtered):
    """The decoded-box entry against the JAX non_max_suppression, frame by
    frame (3 frames of 1575 rows, nc 80: imgsz 160 of v5): equal counts,
    validity, rows and classes, equal scores, boxes within 1e-5."""
    rng = np.random.default_rng(7 + 2 * agnostic + filtered)
    nc = 80
    boxes, scores = _decoded(rng, 3, 1575, nc)
    filt = (np.arange(nc) % 3 != 0) if filtered else None
    kw = dict(conf_thres=0.3, iou_thres=0.4, max_det=100, agnostic=agnostic)
    got = tnms.non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        class_filter=None if filt is None else torch.from_numpy(filt), **kw)
    jfn = jax.jit(lambda b, s: jnms.non_max_suppression(
        b, s, class_filter=None if filt is None else jnp.asarray(filt), **kw))
    for s in range(3):
        want = jax.tree.map(np.asarray, jfn(boxes[s], scores[s]))
        assert int(got.count[s]) == int(want.count) > 10
        np.testing.assert_array_equal(got.valid[s].numpy(), want.valid)
        np.testing.assert_array_equal(got.index[s].numpy(), want.index)
        np.testing.assert_array_equal(got.classes[s].numpy(), want.classes)
        np.testing.assert_array_equal(got.scores[s].numpy(), want.scores)
        np.testing.assert_allclose(got.boxes[s].numpy(), want.boxes, atol=1e-5)
        if filtered:
            assert filt[got.classes[s, :int(got.count[s])].numpy()].all()
