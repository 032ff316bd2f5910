"""The arithmetic of K8's card design (``csrc/conv_s8.cu``), on the CPU.

The card runs K8 for groups 1 as a quantize pass that writes each code
once, channel-minor, then an implicit GEMM on the codes; a depthwise conv
as one launch whose blocks quantize their own tiles. Neither runs here,
so this file holds their decomposition to the plain version and to the
JAX package:

- the quantize pass's plain version ``quantize_codes_plain`` equals
  ``quantize_act`` permuted to (N, H, W, C) and zero-padded to
  ``c_pitch``, and the codes of the jitted JAX ``conv_int8_apply`` (read
  back through a 1x1 identity conv as ``rint(y / xscale)``);
- a torch emulation of the GEMM as the kernel cuts it: M the flattened
  (n, oy, ox) output pixels in tiles of 64 that span images (the last
  one ragged), N the output channels in tiles of ``n_tile``, K chunks of
  32 codes over (tap, ci), each chunk's rows gathered from the codes with
  zeros outside the image, the weights read from ``pack_s8``'s layout,
  int64 sums. It must equal ``conv_s8_plain(sums=True)`` bit for bit
  (both sums are exact), on shapes of each yolov8n class with the planes
  cut to at most 20 x 20 and on the ragged edges; a wrong tap offset or a
  missing zero fill must not;
- a torch emulation of the depthwise form as its blocks take it
  (``dw_plan``: an image, a group of channels and a band of output rows a
  block; the band's input rows and their halo quantized into a
  zero-padded tile, then each output's k*k products), int64 sums bit for
  bit equal to ``conv_s8_plain(sums=True)``, also at yolo11n-pose's pe
  conv at S=8 and on planes cut into bands; a tile without its halo rows
  must not be.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strongsort_yolo_tpu.ops import quant as jquant
from strongsort_yolo_tpu_torch.ops import quant
from strongsort_yolo_tpu_torch.ops.cuda import quant_kernel as qk

# (n, c_in, h, w, c_out, k, stride): tests/test_torch_cuda.py's S8_CASES
# (groups 1) at small planes, one conv of each yolov8n class at 640 with
# its plane cut to 20 x 20 or less, the ragged edges, and the classes of
# yolov7 that yolov8n lacks
GEMM_CASES = [
    (2, 16, 12, 12, 32, 1, 1),     # C_in 16 padded to 32
    (2, 64, 10, 10, 64, 3, 1),
    (2, 64, 10, 10, 128, 3, 2),
    (2, 128, 6, 6, 256, 1, 1),
    (1, 48, 33, 17, 51, 3, 1),     # C_in 48, C_out 51
    (2, 128, 20, 20, 128, 3, 1),   # 3x3 s1 128 -> 128 at 20 x 20
    (2, 64, 20, 20, 64, 3, 1),     # 3x3 s1 64 -> 64 (40 x 40 cut)
    (2, 32, 20, 20, 32, 3, 1),     # 3x3 s1 32 -> 32 (80 x 80 cut)
    (2, 128, 20, 20, 256, 3, 2),   # 3x3 s2 128 -> 256 (from 40 x 40)
    (2, 64, 20, 20, 64, 3, 2),     # 3x3 s2 64 -> 64 (from 80 x 80)
    (2, 512, 20, 20, 256, 1, 1),   # 1x1, the widest C_in
    (2, 96, 20, 20, 64, 1, 1),     # 1x1, C_in 96
    (3, 128, 20, 20, 256, 1, 1),   # tiles across three images, N split
    (1, 32, 21, 21, 64, 3, 2),     # stride 2 on an odd plane
    # yolov7's wide classes, planes cut, M tiles ragged
    (2, 1024, 5, 7, 512, 1, 1),    # 1x1 C_in 1024, 70 pixels
    (1, 2048, 5, 3, 512, 1, 1),    # 1x1 C_in 2048 (SPPCSPC)
    (1, 512, 5, 3, 1024, 3, 1),    # 3x3 512 -> 1024: K = 4608, C_out 1024
    (2, 256, 11, 9, 256, 3, 2),    # 3x3 stride 2 256 -> 256, odd plane
]


def _case(case, seed=0):
    n, c_in, h, w, c_out, k, stride = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1.5, (n, c_in, h, w)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (c_out, c_in, k, k),
                                       dtype=np.int8))
    return x, wq, quant.dynamic_scale(x)


def emulate_gemm(x, wq, xscale, *, stride, pad, mutate=None):
    """The int64 sums (N, C_out, H_out, W_out) of K8's tensor-core form,
    decomposed as the kernel decomposes them. ``mutate``: "tap" swaps a
    tap's row and column offsets, "zfill" reads the image's edge where
    the kernel fills zeros."""
    n, c_in, h, w = x.shape
    c_out, _, k, _ = wq.shape
    h_out = (h + 2 * pad - k) // stride + 1
    w_out = (w + 2 * pad - k) // stride + 1
    hw_out, m_total = h_out * w_out, n * h_out * w_out
    codes = qk.quantize_codes_plain(x, xscale).reshape(-1).long()
    pitch = qk.c_pitch(c_in)
    blob = qk.pack_s8(wq).long()  # (chunks, 2, co_pad, 16)
    m_tiles = -(-m_total // qk.BM)
    bn = qk.n_tile(c_out)
    cpt = pitch // qk.BK
    assert blob.shape[0] == k * k * cpt and blob.shape[2] % qk.CO_ALIGN == 0

    m = torch.arange(m_tiles * qk.BM).reshape(m_tiles, qk.BM)  # a row a pixel
    ok = m < m_total
    img, pix = torch.where(ok, m // hw_out, 0), m % hw_out
    iy0 = (pix // w_out) * stride - pad
    ix0 = (pix % w_out) * stride - pad
    half = torch.arange(qk.BK)  # a chunk's 32 codes: two 16-byte halves
    out = torch.zeros((m_tiles, qk.BM, -(-c_out // bn) * bn), dtype=torch.long)
    for nt in range(-(-c_out // bn)):
        nc0 = nt * bn
        acc = torch.zeros((m_tiles, qk.BM, bn), dtype=torch.long)
        for c in range(k * k * cpt):
            tap, ci0 = c // cpt, (c % cpt) * qk.BK
            dy, dx = (tap % k, tap // k) if mutate == "tap" else (tap // k,
                                                                  tap % k)
            iy, ix = iy0 + dy, ix0 + dx
            inside = ok & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            if mutate == "zfill":
                iy, ix, inside = iy.clamp(0, h - 1), ix.clamp(0, w - 1), ok
            src = ((img * h + iy.clamp(0, h - 1)) * w + ix.clamp(0, w - 1))
            a = codes[(src * pitch + ci0)[..., None] + half]
            a = torch.where(inside[..., None], a, 0)
            b = blob[c, :, nc0:nc0 + bn].permute(1, 0, 2).reshape(bn, qk.BK)
            acc += torch.einsum("tmk,nk->tmn", a, b)
        out[..., nc0:nc0 + bn] = acc
    sums = out.reshape(-1, out.shape[-1])[:m_total, :c_out]
    return sums.reshape(n, h_out, w_out, c_out).permute(0, 3, 1, 2)


def emulate_dw(x, wq, xscale, *, stride, pad, mutate=None):
    """The depthwise form's int64 sums as its blocks compute them: per
    block of ``dw_plan`` (an image, cg channels, bh output rows), the
    band's input rows and their halo quantized from x into a tile of
    cg x ((bh - 1) stride + k) x (w + 2 pad) codes, zero outside the
    image, then each output's k*k products. ``mutate="halo"`` fills only
    the band's own rows, not the halo rows above and below."""
    n, c, h, w = x.shape
    k = wq.shape[-1]
    h_out = (h + 2 * pad - k) // stride + 1
    w_out = (w + 2 * pad - k) // stride + 1
    cg, bh = qk.dw_plan(n, c, h_out, w_out, k=k, stride=stride, w=w, pad=pad)
    wk = qk.pack_s8(wq, c).long()  # (C, k * k)
    ih = (bh - 1) * stride + k
    out = torch.zeros((n, c, h_out, w_out), dtype=torch.long)
    for c0 in range(0, c, cg):
        cs = slice(c0, min(c, c0 + cg))
        for oy0 in range(0, h_out, bh):
            rows = min(bh, h_out - oy0)
            iy0 = oy0 * stride - pad
            lo, hi = max(iy0, 0), min(iy0 + ih, h)
            if mutate == "halo":
                lo, hi = max(lo, oy0 * stride), min(hi, (oy0 + rows) * stride)
            tile = torch.zeros((n, cs.stop - c0, ih, w + 2 * pad),
                               dtype=torch.long)
            tile[:, :, lo - iy0:hi - iy0, pad:pad + w] = qk.quantize_act(
                x[:, cs, lo:hi], xscale).long()
            acc = torch.zeros((n, cs.stop - c0, rows, w_out), dtype=torch.long)
            for ky in range(k):
                for kx in range(k):
                    win = tile[:, :, ky::stride, kx::stride][:, :, :rows, :w_out]
                    acc += win * wk[cs, ky * k + kx][None, :, None, None]
            out[:, cs, oy0:oy0 + rows] = acc
    return out


def _dw_case(case, seed=1):
    n, c, h, w, k, stride = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1.5, (n, c, h, w)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (c, 1, k, k), dtype=np.int8))
    xs = quant.dynamic_scale(x)
    pad = (k - 1) // 2
    want = qk.conv_s8_plain(x, wq, torch.ones(c), torch.zeros(c), xs,
                            stride=stride, pad=pad, groups=c, sums=True)
    return x, wq, xs, pad, want.long()


@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_gemm_decomposition_equals_plain(case):
    x, wq, xs = _case(case)
    stride, pad = case[6], (case[5] - 1) // 2
    want = qk.conv_s8_plain(x, wq, torch.ones(case[4]), torch.zeros(case[4]),
                            xs, stride=stride, pad=pad, sums=True)
    got = emulate_gemm(x, wq, xs, stride=stride, pad=pad)
    assert got.shape == want.shape
    assert torch.equal(got, want.long())


@pytest.mark.parametrize("mutate", ["tap", "zfill"])
def test_gemm_decomposition_mutations_fail(mutate):
    case = (2, 64, 10, 10, 64, 3, 1)
    x, wq, xs = _case(case, seed=3)
    want = qk.conv_s8_plain(x, wq, torch.ones(64), torch.zeros(64), xs,
                            stride=1, pad=1, sums=True)
    got = emulate_gemm(x, wq, xs, stride=1, pad=1, mutate=mutate)
    assert not torch.equal(got, want.long())


# (n, c, h, w, k, stride): yolo11n-pose's pe conv (128 channels at 20 x
# 20; S=8 as the main path gives it), odd planes, k = 5, and planes that
# dw_plan cuts into bands of rows (stride 1 and 2, a ragged last band)
DW_CASES = [(2, 128, 20, 20, 3, 1), (1, 48, 17, 9, 3, 2), (2, 16, 8, 8, 5, 1),
            (8, 128, 20, 20, 3, 1), (1, 4, 96, 96, 3, 1),
            (1, 6, 150, 90, 5, 2)]


@pytest.mark.parametrize("case", DW_CASES, ids=str)
def test_dw_from_codes_equals_plain(case):
    """The depthwise form's sums, from the codes each block quantizes
    into its own tile, equal the plain version's bit for bit."""
    x, wq, xs, pad, want = _dw_case(case)
    assert torch.equal(emulate_dw(x, wq, xs, stride=case[5], pad=pad), want)


@pytest.mark.parametrize("case", DW_CASES[4:], ids=str)
def test_dw_tile_without_halo_fails(case):
    x, wq, xs, pad, want = _dw_case(case)
    assert qk.dw_plan(*want.shape, k=case[4], stride=case[5], w=case[3],
                      pad=pad)[1] < want.shape[2]  # cut into bands
    got = emulate_dw(x, wq, xs, stride=case[5], pad=pad, mutate="halo")
    assert not torch.equal(got, want)


@pytest.mark.parametrize("case", DW_CASES + [(8, 512, 80, 640, 3, 1),
                                             (1, 3, 9000, 9000, 5, 1)], ids=str)
def test_dw_plan_rule(case):
    """dw_plan's blocks: whole planes where they are small, else bands
    whose outputs fill 16-byte stores; at least DW_BLOCKS blocks unless a
    block holds one channel; its shared memory (the tile, the taps, two
    floats a channel) within DW_SMEM."""
    n, c, h, w, k, stride = case
    pad = (k - 1) // 2
    h_out = (h + 2 * pad - k) // stride + 1
    w_out = (w + 2 * pad - k) // stride + 1
    cg, bh = qk.dw_plan(n, c, h_out, w_out, k=k, stride=stride, w=w, pad=pad)
    assert 1 <= cg <= c and 1 <= bh <= h_out
    if h_out * w_out <= qk.DW_OUTPUTS:
        assert bh == h_out
    elif bh > 1:
        assert bh * w_out % 8 == 0 and bh * w_out <= qk.DW_OUTPUTS
    assert cg == 1 or n * -(-c // cg) * -(-h_out // bh) >= qk.DW_BLOCKS
    assert qk.dw_smem(cg, bh, k=k, stride=stride, w=w, pad=pad) <= qk.DW_SMEM
    assert qk.dw_smem(cg, bh, k=k, stride=stride, w=w, pad=pad) >= (
        cg * ((bh - 1) * stride + k) * (w + 2 * pad) + cg * k * k + 8 * cg)


@pytest.mark.parametrize("scale", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in", [16, 48, 64, 96])
def test_codes_equal_quantize_act_and_jax(c_in, dtype, scale):
    rng = np.random.default_rng(c_in)
    x = torch.from_numpy(rng.normal(0, 2.0, (2, c_in, 7, 5)).astype(
        np.float32)).to(dtype)
    xs = (quant.dynamic_scale(x) if scale == "dynamic"
          else torch.tensor(np.float32(3.5 / 127.0)))
    codes = qk.quantize_codes_plain(x, xs)
    pitch = qk.c_pitch(c_in)
    assert codes.shape == (2, 7, 5, pitch) and codes.dtype == torch.int8
    assert pitch % qk.BK == 0 and pitch >= c_in
    assert torch.equal(codes[..., :c_in],
                       qk.quantize_act(x, xs).permute(0, 2, 3, 1))
    assert not codes[..., c_in:].any()

    # the JAX conv_int8_apply's codes, through a 1x1 identity conv: its
    # float32 output is code * xscale within a few float32 ulps (XLA may
    # reassociate the dynamic scale's division), so rint(y / xscale) reads
    # each code back exactly; x in float32, exact for bf16 values
    p = {"wq": jnp.eye(c_in, dtype=jnp.int8)[None, None],
         "wscale": jnp.ones((c_in,), jnp.float32),
         "b": jnp.zeros((c_in,), jnp.float32)}
    if scale == "static":
        p["xscale"] = jnp.float32(3.5 / 127.0)
    xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy())
    y = np.asarray(jax.jit(lambda p, x: jquant.conv_int8_apply(
        p, x, act=False))(p, xj))
    xsf = np.float32(xs.reshape(()).item())
    np.testing.assert_allclose(y, codes[..., :c_in].numpy() * xsf,
                               rtol=4 * 2.0 ** -23, atol=0)
    jax_codes = np.rint(y.astype(np.float64) / xsf).astype(np.int8)
    np.testing.assert_array_equal(jax_codes, codes[..., :c_in].numpy())


def test_pack_s8_layout():
    """pack_s8[chunk, half, co, j] is wq at (co, ci, ky, kx) of chunk
    (ky, kx, ci0) and ci = ci0 + 16 half + j, zero past C_in and C_out."""
    rng = np.random.default_rng(4)
    wq = torch.from_numpy(rng.integers(-127, 128, (51, 48, 3, 3),
                                       dtype=np.int8))
    blob = qk.pack_s8(wq)
    assert blob.shape == (9 * 2, 2, 64, 16) and blob.is_contiguous()
    for c in range(blob.shape[0]):
        tap, ci0 = c // 2, (c % 2) * 32
        for half in range(2):
            for j in range(16):
                ci = ci0 + 16 * half + j
                col = blob[c, half, :, j]
                if ci < 48:
                    assert torch.equal(col[:51], wq[:, ci, tap // 3, tap % 3])
                else:
                    assert not col.any()
                assert not col[51:].any()


@pytest.mark.parametrize("c_out, want", [
    (16, 32), (32, 32), (51, 64), (64, 64), (128, 64), (256, 64)])
def test_n_tile_rule(c_out, want):
    """32 output channels a block where C_out fits, else 64; the packed
    weights' rows (C_out padded to CO_ALIGN) cover every tile."""
    bn = qk.n_tile(c_out)
    assert bn == want and bn in qk.N_TILES
    co_pad = -(-c_out // qk.CO_ALIGN) * qk.CO_ALIGN
    assert -(-c_out // bn) * bn <= co_pad
