"""A numpy emulation of K2's card design (``csrc/nms_keep.cu``) against
K2's plain version and the TPU NMS kernel (interpret mode), bit for bit.

The emulation follows the kernel step by step: the suppression words
sup[j][w] are formed as the warp's ballot of ``iou[j, 32 w + lane] > t``
for ``i > j`` (the IoU in the kernel's expression order, every float32
operation rounded on its own), only for the words that can hold a bit
(``w >= j // 32``; the others are filled with ones, so a scan that read
one would go wrong); the scan takes 32 rows at a time, resolving a
tile's keep bits in registers in row order from its diagonal words and
its removed word, then ORs the kept rows' words into the removed words
of the later tiles. Greedy NMS has one answer, so the keep mask must
equal ``nms_keep_plain`` and ``pallas_nms_keep`` exactly. A mutation
that resolves a tile's rows in the wrong order must fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops.pallas.nms_kernel import pallas_nms_keep
from strongsort_yolo_tpu_torch.ops.cuda.nms_kernel import nms_keep_plain

IOU, CONF = 0.4, 0.3
ALL_ONES = np.uint32(0xFFFFFFFF)


def build_words(boxes: np.ndarray) -> np.ndarray:
    """(K, 4) float32 boxes -> (K, ceil(K / 32)) uint32 words sup[j][w],
    bit `lane` set when box j suppresses box i = 32 w + lane (i > j, IoU
    above the threshold); words the kernel never builds are all ones."""
    k = boxes.shape[0]
    nwords = (k + 31) // 32
    f32 = np.float32
    x1, y1, x2, y2 = (boxes[:, c].astype(f32) for c in range(4))
    area = np.maximum(x2 - x1, f32(0)) * np.maximum(y2 - y1, f32(0))
    iw = np.maximum(np.minimum(x2[:, None], x2[None]) -
                    np.maximum(x1[:, None], x1[None]), f32(0))
    ih = np.maximum(np.minimum(y2[:, None], y2[None]) -
                    np.maximum(y1[:, None], y1[None]), f32(0))
    inter = iw * ih
    den = ((area[:, None] + area[None]) - inter) + f32(1e-7)
    with np.errstate(invalid="ignore", divide="ignore"):
        hit = (inter / den) > f32(IOU)
    hit &= np.arange(k)[None] > np.arange(k)[:, None]
    padded = np.zeros((k, nwords * 32), bool)
    padded[:, :k] = hit
    lanes = padded.reshape(k, nwords, 32).astype(np.uint64)
    words = (lanes << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    built = np.arange(nwords)[None] >= (np.arange(k) // 32)[:, None]
    return np.where(built, words, ALL_ONES)


def scan(words: np.ndarray, valid: np.ndarray, reverse_tile: bool = False
         ) -> np.ndarray:
    """The scan of one warp, 32 rows a tile -> (K,) bool keep mask.
    ``reverse_tile`` resolves each tile's rows last to first (a fault)."""
    k, nwords = words.shape
    removed = [0] * nwords  # lane w's word
    keep = np.zeros(k, bool)
    for t in range(nwords):
        rows = [32 * t + b for b in range(32)]
        vbits = sum(1 << b for b, i in enumerate(rows) if i < k and valid[i])
        diag = [int(words[i, t]) if i < k else 0 for i in rows]
        r, kept = removed[t], 0
        order = range(31, -1, -1) if reverse_tile else range(32)
        for b in order:
            alive = ((vbits & ~r) >> b) & 1
            kept |= alive << b
            r |= diag[b] if alive else 0
        for b, i in enumerate(rows):
            if i < k:
                keep[i] = (kept >> b) & 1
        for w in range(t + 1, nwords):
            for b in range(32):
                if (kept >> b) & 1:
                    removed[w] |= int(words[32 * t + b, w])
    return keep


def emulate(boxes: np.ndarray, conf: np.ndarray, **kw) -> np.ndarray:
    return scan(build_words(boxes), conf >= np.float32(CONF), **kw)


def pallas_keep(boxes: np.ndarray, conf: np.ndarray) -> np.ndarray:
    """The TPU kernel in interpret mode; K padded to its multiple of 128
    with invalid rows after the real ones (which cannot change them)."""
    k = boxes.shape[0]
    kp = max(128, -(-k // 128) * 128)
    b = np.zeros((kp, 4), np.float32)
    c = np.zeros(kp, np.float32)
    b[:k], c[:k] = boxes, conf
    out = pallas_nms_keep(jnp.asarray(b), jnp.asarray(c), iou_thres=IOU,
                          conf_thres=CONF, interpret=True)
    return np.asarray(out)[:k]


def plain_keep(boxes: np.ndarray, conf: np.ndarray) -> np.ndarray:
    return nms_keep_plain(torch.from_numpy(boxes)[None],
                          torch.from_numpy(conf)[None], iou_thres=IOU,
                          conf_thres=CONF)[0].numpy()


def chains(rng, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Random boxes, plus chains A, B, C of 60 px boxes 25 px apart (A
    kills B, B would kill C, so C survives) on rows 30-32 and 62-64, each
    across a tile boundary, and class offsets on the rows past 70."""
    xy = rng.uniform(0, 300, (k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (k, 2))], -1)
    for a, y in ((30, 400.0), (62, 600.0)):
        for m in range(3):
            boxes[a + m] = [400.0 + 25 * m, y, 460.0 + 25 * m, y + 60]
    boxes[70:] += rng.integers(0, 3, (k - 70, 1)) * 7680.0
    conf = np.maximum(-np.sort(-rng.uniform(0, 1, k)), 0.31)
    return boxes.astype(np.float32), conf.astype(np.float32)


def random_case(rng, k: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    if kind == "clusters":  # dense clusters with class offsets
        centers = rng.uniform(50, 600, (8, 2))
        pick = rng.integers(0, 8, k)
        c = centers[pick] + rng.normal(0, 15, (k, 2))
        wh = rng.uniform(20, 100, (k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
        boxes += rng.integers(0, 3, (k, 1)) * 7680.0
    else:
        xy = rng.uniform(0, 300, (k, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (k, 2))], -1)
    conf = -np.sort(-rng.uniform(0, 1, k))
    if kind == "all invalid":
        conf = conf * 0.25
    return boxes.astype(np.float32), conf.astype(np.float32)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 100, 512])
@pytest.mark.parametrize("kind", ["clusters", "uniform"])
def test_emulation_equals_plain_and_pallas(k, kind):
    boxes, conf = random_case(np.random.default_rng(k), k, kind)
    got = emulate(boxes, conf)
    np.testing.assert_array_equal(got, plain_keep(boxes, conf))
    np.testing.assert_array_equal(got, pallas_keep(boxes, conf))


@pytest.mark.parametrize("k", [33, 512])
def test_all_invalid_keeps_nothing(k):
    boxes, conf = random_case(np.random.default_rng(7), k, "all invalid")
    got = emulate(boxes, conf)
    assert not got.any()
    np.testing.assert_array_equal(got, plain_keep(boxes, conf))
    np.testing.assert_array_equal(got, pallas_keep(boxes, conf))


@pytest.mark.parametrize("k", [80, 100])
def test_suppression_chains_across_tiles(k):
    boxes, conf = chains(np.random.default_rng(k), k)
    got = emulate(boxes, conf)
    assert got[[30, 32, 62, 64]].all() and not got[[31, 63]].any()
    np.testing.assert_array_equal(got, plain_keep(boxes, conf))
    np.testing.assert_array_equal(got, pallas_keep(boxes, conf))


def test_unbuilt_words_are_never_read():
    """The words below a row's tile are left all ones; with them zeroed
    instead the scan gives the same mask."""
    boxes, conf = random_case(np.random.default_rng(3), 200, "clusters")
    words = build_words(boxes)
    k, nwords = words.shape
    unbuilt = np.arange(nwords)[None] < (np.arange(k) // 32)[:, None]
    assert (words[unbuilt] == ALL_ONES).all() and unbuilt.any()
    valid = conf >= np.float32(CONF)
    np.testing.assert_array_equal(
        scan(np.where(unbuilt, np.uint32(0), words), valid),
        scan(words, valid))


def test_tile_resolved_in_wrong_order_fails():
    """Resolving a tile's rows last to first breaks the chains: the
    emulation tells the right order from a wrong one."""
    boxes, conf = chains(np.random.default_rng(100), 100)
    want = plain_keep(boxes, conf)
    np.testing.assert_array_equal(emulate(boxes, conf), want)
    assert not np.array_equal(emulate(boxes, conf, reverse_tile=True), want)
