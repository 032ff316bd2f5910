"""The decompositions of K7's CUDA forms, emulated in plain PyTorch on the
CPU and held against ``conv_act_plain`` on every conv shape the K7 rule
picks at imgsz 160 (yolov8n, yolo11n-pose, yolov8n-seg):

- the ``taps`` form (``csrc/conv_act.cuh``): 8x16 output tiles with a
  zero halo, C_in in chunks zero-padded to ``core_chunk``, N tiles of
  ``core_n_tile`` over C_out with the ragged ones masked, float32 sums in
  the kernel's order (chunk, channel, dy, dx);
- the ``im2col`` forms: the gathered (k*k*C_in) rows in (ky, kx, ci)
  order, walked in the bfloat16 form's 16-entry steps over
  ``pack_im2col``'s packed weights (``csrc/conv_im2col_mma.cu``) and in
  the float32 form's 16-entry chunks entry by entry over the plain rows;

and ``pack_im2col``'s round trip with its zero padding.

Tolerances: float32 2e-5 x max(1, |ref|) (only the summation order
differs); bfloat16 one bf16 unit at 1.0 of the output scaled by
max(1, |ref|) (both round the float32 result once; a different float32
sum can flip that rounding).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.models import yolo as tyolo
from strongsort_yolo_tpu_torch.ops.cuda import conv_kernel as tck

BF16_ULP_AT_1 = 2.0 ** -7
TOL = {torch.float32: 2e-5, torch.bfloat16: BF16_ULP_AT_1}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _picks_at_160():
    shapes = set()
    for name in ("yolov8n", "yolo11n-pose", "yolov8n-seg"):
        model = tyolo.YoloModel(tyolo.build_model(name), fused=True)
        shapes |= {p[1:] for p in tyolo.kernel_picks(model, (160, 160))}
    return sorted(shapes)


def _inputs(seed, n, h, w, c_in, c_out, k, dtype):
    """x (n, c_in, h, w) in ``dtype``, w (k*k*c_in, c_out) and b (c_out,)
    float32, seeded."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (n, c_in, h, w)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(0, 1, (k * k * c_in, c_out))
                           * np.sqrt(2.0 / (k * k * c_in))).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.3, c_out).astype(np.float32))
    return x.to(dtype), wt, b


def _epilogue(acc, b, act, dtype):
    """+ float32 bias, SiLU, one rounding to ``dtype``."""
    y = acc + b
    if act:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y.to(dtype)


def _taps_emulation(x, w, b, k, act):
    """The taps form: per 8x16 tile of each image (zero halo, ragged tiles
    padded), per chunk of core_chunk input channels (zero past C_in), per
    channel, dy, dx, the shifted slab times the tap's weights of every N
    tile (zero past C_out), summed in float32. x (n, c_in, h, w) ->
    (n, h, w, c_out)."""
    n, c_in, h, wd = x.shape
    c_out = w.shape[1]
    th, tw = tck.CORE_TILE
    ck = tck.core_chunk(k, "taps", x.dtype)
    n_tile = tck.core_n_tile(c_out)
    n_pad = -(-c_out // n_tile) * n_tile
    ci_pad = -(-c_in // ck) * ck
    hp, wp = -(-h // th) * th, -(-wd // tw) * tw
    r = k // 2
    xs = torch.zeros((n, ci_pad, hp + 2 * r, wp + 2 * r))
    xs[:, :c_in, r:r + h, r:r + wd] = x.float()
    ws = torch.zeros((k * k, ci_pad, n_pad))
    ws[:, :c_in, :c_out] = w.to(x.dtype).float().reshape(k * k, c_in, c_out)
    acc = torch.zeros((n, hp, wp, n_pad))
    for c0 in range(0, ci_pad, ck):
        for ci in range(c0, c0 + ck):
            for dy in range(k):
                for dx in range(k):
                    xv = xs[:, ci, dy:dy + hp, dx:dx + wp, None]
                    acc = torch.addcmul(acc, xv, ws[dy * k + dx, ci])
    return _epilogue(acc[:, :h, :wd, :c_out], b, act, x.dtype)


def _rows(x, k):
    """The gathered im2col rows: (n * h * w, k*k*C_in) in (ky, kx, ci)
    order, zero where a tap leaves the image, pixels in (image, y, x)
    order."""
    n, c_in, h, wd = x.shape
    r = k // 2
    xp = F.pad(x.float(), (r, r, r, r))
    taps = torch.stack([xp[:, :, dy:dy + h, dx:dx + wd]
                        for dy in range(k) for dx in range(k)], 1)
    return taps.permute(0, 3, 4, 1, 2).reshape(n * h * wd, k * k * c_in)


def _im2col_emulation(x, w, b, k, act):
    """The im2col forms over the gathered rows, M tiles of 64 (bfloat16)
    or 128 (float32) consecutive pixels, padded: bfloat16 walks the
    packed weights (pack_im2col) in stages of two 16-entry steps, each
    step one float32 product; float32 walks the plain rows in 16-entry
    chunks entry by entry, over N tiles of core_n_tile. -> (n, h, w,
    c_out)."""
    n, c_in, h, wd = x.shape
    c_out = w.shape[1]
    rows = _rows(x, k)
    m = rows.shape[0]
    if x.dtype == torch.bfloat16:
        blob = tck.pack_im2col(w)
        chunks, _, _, n_pad, _ = blob.shape
        m_pad = -(-m // 64) * 64
        a = torch.zeros((m_pad, chunks * 16))
        a[:m, :rows.shape[1]] = rows
        acc = torch.zeros((m_pad, n_pad))
        for s in range(chunks // 2):
            for step in range(2):
                c = 2 * s + step
                bm = blob[c, 0].float().permute(1, 0, 2).reshape(n_pad, 16)
                acc = acc + a[:, 16 * c:16 * c + 16] @ bm.T
    else:
        kc = tck.core_chunk(k, "im2col", x.dtype)
        n_tile = tck.core_n_tile(c_out)
        n_pad = -(-c_out // n_tile) * n_tile
        k_pad = -(-rows.shape[1] // kc) * kc
        m_pad = -(-m // tck.CORE_M) * tck.CORE_M
        a = torch.zeros((m_pad, k_pad))
        a[:m, :rows.shape[1]] = rows
        wpad = torch.zeros((k_pad, n_pad))
        wpad[:rows.shape[1], :c_out] = w
        acc = torch.zeros((m_pad, n_pad))
        for e in range(k_pad):
            acc = torch.addcmul(acc, a[:, e, None], wpad[e])
    y = _epilogue(acc[:m, :c_out], b, act, x.dtype)
    return y.reshape(n, h, wd, c_out)


def _check(emulate, dtype):
    shapes = _picks_at_160()
    assert shapes
    for h, w, c_in, c_out, k, act in shapes:
        x, wt, b = _inputs(h + c_in + c_out + k, 2, h, w, c_in, c_out, k, dtype)
        got = emulate(x, wt, b, k, act).float()
        want = tck.conv_act_plain(x, wt, b, k=k, act=act,
                                  layout="nchw").permute(0, 2, 3, 1).float()
        assert got.shape == want.shape
        err = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        assert err <= TOL[dtype], ((h, w, c_in, c_out, k, act), dtype, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_taps_tiling_matches_plain_on_the_picks_at_160(dtype):
    _check(_taps_emulation, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_im2col_k_walk_matches_plain_on_the_picks_at_160(dtype):
    _check(_im2col_emulation, dtype)


def test_taps_tiling_masks_ragged_tiles_and_wide_c_out():
    """Shapes off the rule's picks: ragged 8x16 tiles (37x53), C_in
    below one chunk, C_out over two N tiles (200 -> 2 x 128, masked)."""
    for (h, w, c_in, c_out, k), dtype in (((37, 53, 16, 20, 3), torch.float32),
                                          ((16, 24, 8, 200, 1), torch.float32),
                                          ((37, 53, 5, 51, 3), torch.bfloat16)):
        x, wt, b = _inputs(c_out, 2, h, w, c_in, c_out, k, dtype)
        for emulate in (_taps_emulation, _im2col_emulation):
            got = emulate(x, wt, b, k, True).float()
            want = tck.conv_act_plain(x, wt, b, k=k, act=True,
                                      layout="nchw").permute(0, 2, 3, 1).float()
            err = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
            assert err <= TOL[dtype], (emulate.__name__, (h, w, c_in, c_out, k), err)


def test_core_tiles():
    """N tiles: the smallest of 32, 64, 80, 128 that holds C_out, else
    128; K chunks: 4 channels (x 9 taps) for k = 3, 16 (float32) or 8
    (bfloat16) for k = 1, 16 row entries for im2col."""
    assert [tck.core_n_tile(c) for c in (1, 16, 32, 33, 51, 64, 80, 81, 128, 200)] \
        == [32, 32, 32, 64, 64, 64, 80, 128, 128, 128]
    assert tck.core_chunk(3, "taps", torch.float32) == 4
    assert tck.core_chunk(3, "taps", torch.bfloat16) == 4
    assert tck.core_chunk(1, "taps", torch.float32) == 16
    assert tck.core_chunk(1, "taps", torch.bfloat16) == 8
    assert tck.core_chunk(3, "im2col", torch.float32) == 16
    assert tck.CORE_TILE[0] * tck.CORE_TILE[1] == tck.CORE_M == 128


@pytest.mark.parametrize("k,c_in,c_out", [(3, 51, 80), (1, 51, 51), (3, 16, 128),
                                          (1, 192, 200), (3, 5, 20)])
def test_pack_im2col_round_trips_with_zero_padding(k, c_in, c_out):
    """pack_im2col -> (K_pad / 16, 1, 2, N_pad, 8) bf16 over the k*k*C_in
    row entries: unpack_mma with k = 1 gives the bf16-rounded weight back,
    K_pad is whole 32-entry stages (a multiple of 64), and every entry
    past the row and every channel past C_out is zero."""
    w = torch.from_numpy(np.random.default_rng(c_in + k).normal(
        0, 1, (k * k * c_in, c_out)).astype(np.float32))
    blob = tck.pack_im2col(w)
    rows = k * k * c_in
    chunks = tck.mma_chunks(rows, 1)
    assert blob.dtype == torch.bfloat16 and blob.is_contiguous()
    assert blob.shape[:3] == (chunks, 1, 2) and blob.shape[4] == 8
    assert chunks * 16 % 64 == 0 and rows <= chunks * 16 < rows + 64
    assert blob.shape[3] % tck.mma_n_tile(c_out) == 0 and blob.shape[3] >= c_out
    assert torch.equal(tck.unpack_mma(blob, 1, rows, c_out),
                       w.to(torch.bfloat16))
    full = tck.unpack_mma(blob, 1, chunks * 16, blob.shape[3])
    assert not full[rows:].any() and not full[:, c_out:].any()
