"""A numpy emulation of the card designs of K1 (``csrc/letterbox.cu``) and
K4 (``csrc/banded_crop.cu``) against their plain versions and the JAX
package, bit for bit.

K1 runs one block per (output row, frame). A bar row stores the gray. A
content row reads its row taps once and reads source row y0 (and y1 only
where its weight is not 0) in place; each thread writes a run of 8
output columns of the three planes, each element deciding on its own
whether it lies in a side bar. A hi tap of weight 0 is not read, and
where both taps of both axes weigh exactly 1 and 0 (decimation) the
pixel's v / 255 comes from a 256-entry table that only such rows build.

K4 runs one block per (slot, tile of 16 output rows, tile of 64
columns). The tile's 32 row taps (lo and hi of each row) name the source
rows it reads; one warp keeps each distinct weighed row once, numbered
in order of first appearance (the lanes' shuffles and ballot emulated as
a loop); the column pass runs once per distinct row and rounds to the
compute dtype; the row pass weighs the two rows of each output row.

Both emulations compute in float32 with every product and sum rounded on
its own (numpy float32 operations), as the kernels do under -fmad=false,
and round to bfloat16 with torch. They must equal the plain versions
exactly; against the JAX functions the bars of the existing tests hold
(K1: exact for decimation, 1e-6 otherwise; K4: 1e-6 in float32, one bf16
unit at 1.0 in bfloat16). Mutations that must fail: a run straddling a
side bar treated as all content, a weighed tap skipped, and a tile whose
row pass takes the neighbouring output row's weights.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops.pallas.crop_kernel import (
    banded_crop_packed as j_banded_crop_packed,
)
from strongsort_yolo_tpu_torch.ops import crops as tcrops
from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import banded_crop_plain
from strongsort_yolo_tpu_torch.ops.letterbox import (
    PAD_VALUE,
    letterbox,
    letterbox_params,
    resize_taps,
)

# the module, not the function that strongsort_yolo_tpu.ops re-exports
jlb = importlib.import_module("strongsort_yolo_tpu.ops.letterbox")

F32 = np.float32
RUN = 8  # output columns per thread (K1) and per store (both)
TILE_ROWS, TILE_COLS = 16, 64  # K4's block tile
OUT_HW = (128, 64)
BF16_TOL = 2.0**-7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def round_to(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 values rounded to ``dtype`` and widened back."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(dtype).float().numpy()


# ---------------------------------------------------------------- K1


def k1_emulate(frames: np.ndarray, lp, dtype, *, straddle_as_content: bool = False,
               skip_weighed_tap: bool = False) -> tuple[np.ndarray, dict]:
    """(B, H, W, 3) uint8 -> ((B, 3, size, size) float32 values of
    ``dtype``, counts of what the blocks did)."""
    b, h, w, _ = frames.shape
    taps = resize_taps((h, w), lp)
    idx, wts = taps.idx.numpy(), taps.w.numpy()
    nh, nw, size, left = lp.new_h, lp.new_w, lp.size, lp.left
    cx_lo, cx_hi = idx[0, nh:], idx[1, nh:]
    cw_lo, cw_hi = wts[0, nh:], wts[1, nh:]
    pad = F32(PAD_VALUE) / F32(255.0)
    div255 = np.arange(256, dtype=F32) / F32(255.0)  # the block's table
    n_runs = -(-size // RUN)
    x = np.arange(n_runs * RUN).reshape(n_runs, RUN)
    xx = x - left
    content = (xx >= 0) & (xx < nw)
    straddling = int((content.any(1) & ~content.all(1)).sum())
    if straddle_as_content:  # a run with any picture column taken whole
        content = np.broadcast_to(content.any(1, keepdims=True), content.shape)
    xs = np.clip(xx, 0, nw - 1)[content]
    x0, x1 = 3 * cx_lo[xs], 3 * cx_hi[xs]
    wx0, wx1 = cw_lo[xs], cw_hi[xs]
    hi_col = wx1 != 0
    if skip_weighed_tap:
        hi_col = np.zeros_like(hi_col)
    unit_col = (wx0 == 1) & (wx1 == 0)
    out = np.empty((b, 3, size, n_runs * RUN), F32)
    stats = dict(bar_rows=0, rows_read=set(), straddling=straddling,
                 hi_cols_read=int(hi_col.sum()), from_table=0, tables_built=0)
    row_bytes = 3 * w
    for f in range(b):
        flat = frames[f].reshape(-1)
        for y in range(size):
            yy = y - lp.top
            if not 0 <= yy < nh:  # a bar row
                out[f, :, y] = pad
                stats["bar_rows"] += 1
                continue
            y0, y1 = int(idx[0, yy]), int(idx[1, yy])
            wy0, wy1 = wts[0, yy], wts[1, yy]
            r0 = flat[y0 * row_bytes:(y0 + 1) * row_bytes]
            stats["rows_read"].add(y0)
            r1 = None
            if wy1 != 0:
                r1 = flat[y1 * row_bytes:(y1 + 1) * row_bytes]
                stats["rows_read"].add(y1)
            row = np.full((3,) + x.shape, pad, F32)
            unit_row = wy0 == 1 and wy1 == 0  # the block builds the table
            stats["tables_built"] += int(unit_row)
            table = unit_col & unit_row
            stats["from_table"] += 3 * int(table.sum())
            for c in range(3):
                sc = 2 - c  # BGR -> RGB

                def rows_first(col):
                    t = wy0 * r0[col + sc].astype(F32)
                    if r1 is not None:
                        t = t + wy1 * r1[col + sc].astype(F32)
                    return t

                s = wx0 * rows_first(x0)
                s = np.where(hi_col, s + wx1 * rows_first(x1), s)
                row[c][content] = np.where(table, div255[r0[x0 + sc]],
                                           s / F32(255.0))
            out[f, :, y] = row.reshape(3, -1)
    return round_to(out[..., :size], dtype), stats


K1_GEOMETRIES = [((1080, 1920), 640), ((720, 1280), 640), ((1920, 1080), 640),
                 ((481, 853), 640), ((240, 320), 160)]


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("hw,size", K1_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_emulation_equals_plain_and_jax(hw, size, dtype):
    f = _frames(hw[0] + size, (1, *hw, 3))
    lp = letterbox_params(*hw, size)
    got, stats = k1_emulate(f, lp, dtype)
    want = letterbox(torch.from_numpy(f), lp, dtype=dtype).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert stats["bar_rows"] == size - lp.new_h
    if dtype == torch.float32:
        jax_out = np.asarray(jlb.letterbox(
            jnp.asarray(f), jlb.letterbox_params(*hw, size),
            dtype=jnp.float32)).transpose(0, 3, 1, 2)
        decimation = all(jlb._decimation_stride(n, s) is not None
                         for n, s in ((lp.new_h, hw[0]), (lp.new_w, hw[1])))
        tol = 0.0 if decimation else 1e-6
        np.testing.assert_allclose(got, jax_out, rtol=0, atol=tol)


def test_k1_geometries_cover_the_design():
    """Bars above and below, a side bar whose edge falls inside a run of
    8 (portrait: left 140), a two-tap geometry with unaligned 2559-byte
    rows, and decimation that reads only the weighed rows."""
    lp = letterbox_params(1920, 1080, 640)
    assert (lp.left, lp.new_w) == (140, 360) and lp.left % RUN
    _, stats = k1_emulate(_frames(1, (1, 1920, 1080, 3)), lp, torch.float32)
    assert stats["straddling"] == 2 and stats["bar_rows"] == 0
    assert stats["hi_cols_read"] == 0  # pure decimation

    lp = letterbox_params(481, 853, 640)
    assert (lp.top, lp.new_h, lp.left) == (139, 361, 0)
    _, stats = k1_emulate(_frames(2, (1, 481, 853, 3)), lp, torch.float32)
    assert stats["bar_rows"] == 279 and stats["hi_cols_read"] > 0
    assert 3 * 853 % 16 and stats["tables_built"] < lp.new_h

    lp = letterbox_params(1080, 1920, 640)
    _, stats = k1_emulate(_frames(3, (1, 1080, 1920, 3)), lp, torch.float32)
    taps = resize_taps((1080, 1920), lp)
    assert stats["bar_rows"] == 280 and stats["hi_cols_read"] == 0
    assert stats["from_table"] == 3 * 360 * 640  # every picture value
    # the blocks read one source row in three, the rows some tap weighs
    weighed = taps.idx[0, :lp.new_h].unique().tolist()
    assert sorted(stats["rows_read"]) == weighed and len(weighed) == 360


@pytest.mark.parametrize("hw,size", [((1080, 1920), 640), ((1080, 1920), 636),
                                     ((481, 853), 640), ((64, 8150), 640)])
def test_k1_table_only_where_decimation(hw, size):
    """Only rows whose taps weigh 1 and 0 build the byte / 255 table; a
    size that is not a multiple of 8 ends its last run inside the row;
    frames 8150 pixels wide take the same path as any other."""
    f = _frames(hw[1] + size, (1, *hw, 3))
    lp = letterbox_params(*hw, size)
    got, stats = k1_emulate(f, lp, torch.bfloat16)
    want = letterbox(torch.from_numpy(f), lp, dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, want.float().numpy())
    w = resize_taps(hw, lp).w.numpy()
    unit = (w[0, :lp.new_h] == 1) & (w[1, :lp.new_h] == 0)
    assert stats["tables_built"] == int(unit.sum())
    decimation = hw == (1080, 1920) and size == 640
    assert (stats["tables_built"] == lp.new_h) == decimation


def test_k1_straddling_run_as_content_fails():
    f = _frames(5, (1, 1920, 1080, 3))
    lp = letterbox_params(1920, 1080, 640)
    want = letterbox(torch.from_numpy(f), lp).numpy()
    np.testing.assert_array_equal(k1_emulate(f, lp, torch.float32)[0], want)
    bad, _ = k1_emulate(f, lp, torch.float32, straddle_as_content=True)
    assert not np.array_equal(bad, want)


def test_k1_weighed_tap_skipped_fails():
    f = _frames(6, (1, 720, 1280, 3))
    lp = letterbox_params(720, 1280, 640)
    want = letterbox(torch.from_numpy(f), lp).numpy()
    np.testing.assert_array_equal(k1_emulate(f, lp, torch.float32)[0], want)
    bad, _ = k1_emulate(f, lp, torch.float32, skip_weighed_tap=True)
    assert not np.array_equal(bad, want)


# ---------------------------------------------------------------- K4


def k4_taps(base, step, k: np.ndarray, length, dtype):
    """The kernel's ``taps``: position base + k * step rounded once, clamped
    into [0, len - 1]; weights rounded to ``dtype``; hi clamped to len - 1."""
    pos = (k.astype(np.float64) * np.float64(step) + np.float64(base)).astype(F32)
    pos = np.minimum(np.maximum(pos, F32(0)), F32(length) - F32(1))
    fl = np.floor(pos)
    w_lo = round_to(np.maximum(F32(0), F32(1) - np.abs(fl - pos)), dtype)
    w_hi = round_to(np.maximum(F32(0), F32(1) - np.abs(fl + F32(1) - pos)), dtype)
    lo = fl.astype(np.int64)
    hi = np.minimum(lo + 1, int(length) - 1)
    return lo, hi, w_lo, w_hi


def distinct_rows(row: np.ndarray, need: np.ndarray):
    """The warp's numbering of the weighed source rows: lane k's t row is
    that of the first lane reading the same row, t rows numbered in order
    of first appearance; -1 where the tap is not read."""
    lanes = len(row)
    dup = np.arange(lanes)
    for k in range(lanes):
        for i in range(k):  # shuffles from lanes 0..31 in order
            if need[i] and row[i] == row[k] and i < dup[k]:
                dup[k] = i
    firsts = need & (dup == np.arange(lanes))
    slot = np.where(need, np.cumsum(firsts)[dup] - 1, -1)
    return slot, row[firsts]


def k4_emulate(stack: np.ndarray, row_off: np.ndarray, scal: np.ndarray,
               ints: np.ndarray, slot_frame: np.ndarray, dtype,
               out_hw=OUT_HW, *, skip_weighed_tap: bool = False,
               neighbour_weights: bool = False):
    """-> ((G, 3, oh, ow) float32 values of ``dtype``, per-tile counts)."""
    s, _, _, _ = stack.shape
    oh, ow = out_hw
    g_count = scal.shape[0]
    out = np.full((g_count, 3, oh, ow), np.nan, F32)
    tiles = []
    for g in range(g_count):
        yb, ys, xb, xs, hl, wl = (F32(v) for v in scal[g])
        lvl = min(max(int(ints[g, 2]), 0), len(row_off) - 1)
        f = min(max(int(slot_frame[g]), 0), s - 1)
        planes = stack[f, :, int(row_off[lvl]):]
        for q0 in range(0, ow, TILE_COLS):
            q = q0 + np.arange(TILE_COLS)
            valid_q = q < ow
            xlo, xhi, wx0, wx1 = k4_taps(xb, xs, q, wl, dtype)
            xlo, xhi = np.where(valid_q, xlo, 0), np.where(valid_q, xhi, 0)
            wx0, wx1 = np.where(valid_q, wx0, 0), np.where(valid_q, wx1, 0)
            hi_col = wx1 != 0
            if skip_weighed_tap:
                hi_col = np.zeros_like(hi_col)
            for r0 in range(0, oh, TILE_ROWS):
                lane = np.arange(2 * TILE_ROWS)
                r = r0 + lane // 2
                ylo, yhi, wy0, wy1 = k4_taps(yb, ys, r, hl, dtype)
                is_hi = (lane & 1) == 1
                row = np.where(is_hi, yhi, ylo)
                need = (r < oh) & (~is_hi | (wy1 != 0))
                wy = np.where(is_hi, wy1, wy0)
                slot, rows = distinct_rows(row, need)
                tiles.append(len(rows))
                # column pass, once per distinct source row
                t = np.empty((len(rows), 3, TILE_COLS), F32)
                for d, src in enumerate(rows):
                    line = planes[:, src]  # (3, width)
                    v = wx0 * line[:, xlo]
                    v = np.where(hi_col, v + wx1 * line[:, xhi], v)
                    t[d] = round_to(v, dtype)
                # row pass
                for rr in range(TILE_ROWS):
                    if r0 + rr >= oh:
                        continue
                    k = 2 * rr
                    if (neighbour_weights and rr + 1 < TILE_ROWS
                            and r0 + rr + 1 < oh):
                        w0, w1 = wy[k + 2], wy[k + 3]
                    else:
                        w0, w1 = wy[k], wy[k + 1]
                    v = w0 * t[slot[k]]
                    if slot[k + 1] >= 0:
                        v = v + w1 * t[slot[k + 1]]
                    out[g, :, r0 + rr, q0:q0 + TILE_COLS] = round_to(
                        v, dtype)[:, :min(TILE_COLS, ow - q0)]
    return out, np.asarray(tiles)


def _boxes(rng, n, h, w):
    """Boxes for every level, y_step below and above 1, all four frame
    edges, and degenerate ones."""
    frac = rng.choice([0.04, 0.1, 0.3, 0.7, 0.98], n)
    bw = frac * w * rng.uniform(0.3, 1.0, n)
    bh = frac * h * rng.uniform(0.5, 1.0, n)
    x1 = rng.uniform(-30, w - bw / 2)
    y1 = rng.uniform(-30, h - bh / 2)
    edges = [[0, 0, 0, 0], [5, 5, 5, 40], [w - 1, h - 1, w + 30, h + 50],
             [-40, 10, 30, 200], [w - 30, 20, w + 40, 220],
             [100, -50, 160, 30], [40, h - 30, 120, h + 60], [0, 0, w, h],
             [-60, -60, w + 60, h + 60]]
    return np.concatenate([np.stack([x1, y1, x1 + bw, y1 + bh], 1),
                           edges]).astype(F32)


def _packed(rng, counts, h, w):
    """Per-frame boxes packed frame-major, each count padded to 8 with
    the dummy box (the JAX packed kernel's layout)."""
    boxes, frames = [], []
    for f, n in enumerate(counts):
        b = _boxes(rng, n, h, w)
        pad = -(-len(b) // 8) * 8
        boxes.append(np.concatenate([b, np.tile([[0, 0, 16, 32]], (pad - len(b), 1))]))
        frames += [f] * pad
    return np.concatenate(boxes).astype(F32), np.asarray(frames, np.int32)


def _crop_case(seed, hw, counts, dtype):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (len(counts), *hw, 3)).astype(F32)
    boxes, slot_frame = _packed(rng, counts, *hw)
    pyr = tcrops.pyramid_stack(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype))
    scal, ints = tcrops.banded_prep(torch.from_numpy(boxes), hw, pyr.dims,
                                    OUT_HW)
    return x, boxes, slot_frame, pyr, scal, ints


def _emulate_case(pyr, scal, ints, slot_frame, dtype, **kw):
    return k4_emulate(pyr.stack.float().numpy(), pyr.row_off.numpy(),
                      scal.numpy(), ints.numpy(), slot_frame, dtype, **kw)


@pytest.mark.parametrize("hw,counts", [((600, 1000), (13, 5)),
                                       ((481, 853), (11, 3))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_emulation_equals_plain_and_jax(hw, counts, dtype):
    x, boxes, slot_frame, pyr, scal, ints = _crop_case(hw[0], hw, counts, dtype)
    assert set(ints[:, 2].tolist()) == set(range(len(pyr.dims)))
    steps = scal[:, 1].numpy()
    assert (steps < 1).any() and (steps > 1).any()
    got, tiles = _emulate_case(pyr, scal, ints, slot_frame, dtype)
    want = banded_crop_plain(pyr, scal, ints, torch.from_numpy(slot_frame))
    np.testing.assert_array_equal(got, want.float().numpy())
    # upsampled boxes share source rows within a tile; decimated ones not
    assert tiles.min() < 2 * TILE_ROWS // 2 and tiles.max() > TILE_ROWS
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jax_out = j_banded_crop_packed(
        jnp.asarray(x, jdt), jnp.asarray(boxes), jnp.asarray(slot_frame),
        OUT_HW, interpret=True)  # (G, oh, ow, 3) f32
    tol = 1e-6 if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), np.asarray(jax_out),
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_emulation_1080p_three_levels(dtype):
    """1080p frames, three pyramid levels, against the plain version."""
    _, _, slot_frame, pyr, scal, ints = _crop_case(7, (1080, 1920), (9, 6), dtype)
    assert set(ints[:, 2].tolist()) == {0, 1, 2}
    got, _ = _emulate_case(pyr, scal, ints, slot_frame, dtype)
    want = banded_crop_plain(pyr, scal, ints, torch.from_numpy(slot_frame))
    np.testing.assert_array_equal(got, want.float().numpy())


def test_k4_last_row_tap_stays_inside_the_level():
    """A box ending on the level's last row and column: the hi tap of
    weight 0 is not read, and past the level (NaN here) nothing is."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (1, 240, 320, 3)).astype(F32)
    boxes = np.asarray([[200, 150, 340, 260], [319, 239, 400, 300]], F32)
    pyr = tcrops.pyramid_stack(torch.from_numpy(x).permute(0, 3, 1, 2))
    big = torch.full((1, 3, pyr.stack.shape[2] + 4, pyr.stack.shape[3] + 4),
                     float("nan"))
    big[:, :, :pyr.stack.shape[2], :pyr.stack.shape[3]] = pyr.stack
    h0, w0 = pyr.dims[0]
    big[:, :, h0:, :] = float("nan")
    big[:, :, :, w0:] = float("nan")
    pyr = pyr._replace(stack=big)
    scal, ints = tcrops.banded_prep(torch.from_numpy(boxes), (240, 320),
                                    pyr.dims, OUT_HW)
    slot_frame = np.zeros(2, np.int32)
    got, _ = _emulate_case(pyr, scal, ints, slot_frame, torch.float32)
    assert np.isfinite(got).all()
    want = banded_crop_plain(pyr, scal, ints, torch.from_numpy(slot_frame))
    np.testing.assert_array_equal(got, want.numpy())


def test_k4_distinct_rows_numbering():
    """Rows read twice get one t row; rows not read get none; the order
    is that of first appearance, whatever the rows' own order."""
    row = np.array([5, 6, 6, 7, 7, 8, 3, 5] + [0] * 24)
    need = np.array([True] * 8 + [False] * 24)
    need[1] = False  # a hi tap of weight 0
    slot, rows = distinct_rows(row, need)
    assert rows.tolist() == [5, 6, 7, 8, 3]
    assert slot[:8].tolist() == [0, -1, 1, 2, 2, 3, 4, 0]
    assert (slot[8:] == -1).all()


@pytest.mark.parametrize("mutation", ["skip_weighed_tap", "neighbour_weights"])
def test_k4_mutations_fail(mutation):
    _, _, slot_frame, pyr, scal, ints = _crop_case(8, (600, 1000), (7,),
                                                   torch.float32)
    want = banded_crop_plain(pyr, scal, ints,
                             torch.from_numpy(slot_frame)).numpy()
    got, _ = _emulate_case(pyr, scal, ints, slot_frame, torch.float32)
    np.testing.assert_array_equal(got, want)
    bad, _ = _emulate_case(pyr, scal, ints, slot_frame, torch.float32,
                           **{mutation: True})
    assert not np.array_equal(bad, want)


def test_k4_partial_tiles():
    """An output size that is no multiple of the tile (100 x 40): the
    rows and columns past it are never written."""
    _, _, slot_frame, pyr, scal, ints = _crop_case(9, (240, 320), (5,),
                                                   torch.bfloat16)
    scal, ints = tcrops.banded_prep(
        torch.tensor([[10, 20, 200, 230], [0, 0, 0, 0], [300, 200, 330, 260]],
                     dtype=torch.float32), (240, 320), pyr.dims, (100, 40))
    slot_frame = np.zeros(3, np.int32)
    got, _ = k4_emulate(pyr.stack.float().numpy(), pyr.row_off.numpy(),
                        scal.numpy(), ints.numpy(), slot_frame,
                        torch.bfloat16, (100, 40))
    want = banded_crop_plain(pyr, scal, ints, torch.from_numpy(slot_frame),
                             (100, 40))
    np.testing.assert_array_equal(got, want.float().numpy())


# ---------------------------------------------------------------- SASS


def test_div64_calls_tells_the_routine_by_its_conversion():
    """tools/sass.py counts a call as a 64-bit division where its routine
    (from the call's target to its RET) converts with I2F.U64.RP, as the
    parent K1's did, and not the float division's slow path."""
    from strongsort_yolo_tpu_torch.tools.sass import div64_calls

    lines = [(0x10, "CALL.REL.NOINC 0x80"), (0x20, "I2F.U32.RP R0, R7"),
             (0x30, "CALL.REL.NOINC 0x80"), (0x40, "FCHK P0, R9, 255"),
             (0x50, "CALL.REL.NOINC 0xc0"), (0x60, "EXIT"),
             (0x80, "IADD3 R2, P1, RZ, -R5, RZ"),
             (0x90, "I2F.U64.RP R15, R6"), (0xa0, "MUFU.RCP R15, R15"),
             (0xb0, "RET.REL.NODEC R6 0x0"),
             (0xc0, "MUFU.RCP R7, UR4"), (0xd0, "RET.REL.NODEC R2 0x0")]
    assert div64_calls(lines) == (2, 3)
    assert div64_calls([ln for ln in lines if ln[0] >= 0x40]) == (0, 1)
