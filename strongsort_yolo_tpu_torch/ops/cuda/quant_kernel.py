"""K8: the int8 conv of post-training quantization (``csrc/conv_s8.cu``),
its wrapper :func:`conv_s8`, its plain PyTorch version
:func:`conv_s8_plain`, the quantize pass's plain version
:func:`quantize_codes_plain`, the weight packing :func:`pack_s8`, the
rule for the N tile, :func:`n_tile`, and the depthwise form's tiling,
:func:`dw_plan`.

It replaces no Pallas kernel: its counterpart is the JAX package's
``ops/quant.py:41`` ``conv_int8_apply``, an XLA convolution of int8 codes
with int32 sums (the TPU's int8 matrix unit) and its dequantize / bias /
SiLU epilogue. PyTorch has no int8 convolution on CUDA, so the port's is
written for the H100's int8 tensor cores.

What it computes, on NCHW activations, one call per conv:
``xq = clip(round(x / xscale), -127, 127)`` (x widened to float32, a true
division, half to even), int32 sums of ``xq * wq`` over (ky, kx, ci),
then ``y = fma(sum, xscale * wscale[c], b[c])`` rounded once, SiLU
(``y * sigmoid(y)``) if ``act``, one cast to x's dtype. The sums are
exact, so the kernel and the plain version agree on them bit for bit,
and on every output where the epilogue rounds alike: always with
``act=False``, and with the SiLU where the plain version runs
``torch.sigmoid`` on the card (the same ``1 / (1 + expf(-y))``).
Groups 1 or depthwise (groups = C_in = C_out); any k, stride and
padding.

How, on the card, groups 1 (two launches, one wrapper call): a quantize
pass writes each element's code once, channel-minor, into a scratch of
shape (N, H, W, C_pitch) (:func:`quantize_codes_plain` gives the same
array); then an implicit GEMM on the int8 tensor cores (``wgmma``
m64nNk32): M the flattened (n, oy, ox) output pixels in tiles of 64 that
span images, N the output channels in tiles of :func:`n_tile`, K the
(tap, ci) in chunks of 32 codes, each chunk's rows gathered from the
codes with zeros outside the image, the weights packed by :func:`pack_s8`
as the tensor cores read them. Depthwise (one launch): a block per
(image, group of channels, band of output rows) of :func:`dw_plan`
quantizes the band's input rows and their halo from x into shared
memory, with the quantize pass's arithmetic, then sums each output's
k*k products on the CUDA cores.

Bound (chip_smoke): the larger of the bytes (x read once, the weights
once, the output written once) over 3.35 TB/s and 2 x MACs over 1,979
TOPS (int8 dense); at yolov8n's shapes every conv is bound by its bytes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.ops.crops import fma32
from strongsort_yolo_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BK = 32  # codes per K chunk: C_in is padded to it, per tap
BM = 64  # output pixels per block of the tensor-core form
CO_ALIGN = 64  # pack_s8's rows: C_out padded to it
N_TILES = (32, 64)  # output channels per block of the tensor-core form
DW_OUTPUTS = 2048  # output values a depthwise block aims at: 8 a thread
DW_BLOCKS = 264  # depthwise blocks wanted at least: two per H100 SM
DW_SMEM = 48 * 1024  # a depthwise block's shared memory, at most (dw_smem)


def is_depthwise(wq: torch.Tensor, groups: int) -> bool:
    return groups > 1 and wq.shape[1] == 1 and wq.shape[0] == groups


def c_pitch(c_in: int) -> int:
    """Codes per pixel of the quantize pass's output: C_in padded to a
    multiple of ``BK``."""
    return -(-c_in // BK) * BK


def n_tile(c_out: int) -> int:
    """Output channels per block of the tensor-core form: 32 where C_out
    fits in it, else 64. Measured at yolov8n's 32 int8 convs
    (tools/prof_s8.py, PERF.md): a block's chunk loop is a chain of short
    latencies, so more and narrower blocks win; of the convs with C_out
    above 32, 64 beat 32 on all but two 1x1 convs at 20 x 20, and 128 on
    all but one 3x3 stride-2 conv."""
    return N_TILES[0] if c_out <= N_TILES[0] else N_TILES[1]


def dw_plan(n: int, c: int, h_out: int, w_out: int, *, k: int, stride: int,
            w: int, pad: int) -> tuple[int, int]:
    """The depthwise form's block: (cg channels, bh output rows) of one
    image. Whole planes where a plane has at most ``DW_OUTPUTS`` outputs,
    else bands of rows whose outputs fill 16-byte stores; then as many
    channels as make ``DW_OUTPUTS`` outputs, halved while the grid has
    fewer than ``DW_BLOCKS`` blocks (the conv is bound by latency: more
    and smaller blocks), and halved (channels, then rows) while the
    block's shared memory (:func:`dw_smem`) exceeds ``DW_SMEM``."""
    bh = h_out
    if h_out * w_out > DW_OUTPUTS:
        step = 8 // math.gcd(w_out, 8)  # rows whose outputs are whole 16 bytes
        bh = min(h_out, max(step, DW_OUTPUTS // w_out // step * step))
    cg = max(1, min(c, DW_OUTPUTS // (bh * w_out)))

    def blocks(cg, bh):
        return n * -(-c // cg) * -(-h_out // bh)

    def smem(cg, bh):
        return dw_smem(cg, bh, k=k, stride=stride, w=w, pad=pad)

    while cg > 1 and blocks(cg, bh) < DW_BLOCKS:
        cg = -(-cg // 2)
    while cg > 1 and smem(cg, bh) > DW_SMEM:
        cg = -(-cg // 2)
    while bh > 1 and smem(cg, bh) > DW_SMEM:
        bh = -(-bh // 2)
    return cg, bh


def dw_smem(cg: int, bh: int, *, k: int, stride: int, w: int, pad: int) -> int:
    """Bytes of a depthwise block's shared memory: its codes tile, ``cg x
    ((bh - 1) stride + k) x (w + 2 pad)``, and taps, ``cg x k x k``,
    rounded up to 4 bytes, then two floats a channel (the epilogue's
    scale and bias)."""
    codes = cg * ((bh - 1) * stride + k) * (w + 2 * pad) + cg * k * k
    return -(-codes // 4) * 4 + 8 * cg


def _check(x, wq, wscale, b, xscale, groups: int) -> None:
    c_out, cig, k, k2 = wq.shape
    if (x.dim() != 4 or x.dtype not in _DTYPES or wq.dtype != torch.int8
            or k != k2 or x.shape[1] != cig * groups
            or wscale.shape != (c_out,) or b.shape != (c_out,)
            or xscale.numel() != 1):
        raise ValueError(
            f"conv_s8 wants x (N, C_in, H, W) float32 or bfloat16, wq "
            f"(C_out, C_in / groups, k, k) int8, wscale and b (C_out,) and "
            f"one xscale; got {tuple(x.shape)} {x.dtype}, {tuple(wq.shape)} "
            f"{wq.dtype}, {tuple(wscale.shape)}, {tuple(b.shape)}, "
            f"{tuple(xscale.shape)}, groups {groups}")
    if groups != 1 and not is_depthwise(wq, groups):
        raise ValueError(f"conv_s8 takes groups 1 or depthwise convs "
                         f"(groups = C_in = C_out), got groups {groups} of "
                         f"{tuple(wq.shape)}")


def quantize_act(x: torch.Tensor, xscale: torch.Tensor) -> torch.Tensor:
    """The int8 codes of x: clip(round(x / xscale), -127, 127), x in
    float32, a true division by the scale tensor (PyTorch divides by a
    Python scalar as a product with its reciprocal on the card)."""
    q = torch.round(x.float() / xscale.float().reshape(()))
    return torch.clamp(q, -127, 127).to(torch.int8)


def conv_s8_plain(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                  b: torch.Tensor, xscale: torch.Tensor, *, stride: int = 1,
                  pad: int = 0, groups: int = 1, act: bool = True,
                  sums: bool = False) -> torch.Tensor:
    """The plain version: the codes of :func:`quantize_act`, their sums
    as a float64 ``F.conv2d`` (exact: every partial sum is an integer
    below 2^53), then ``ops/crops.fma32`` of the sums as float32, the
    float32 ``xscale * wscale`` and ``b``, SiLU as ``y * sigmoid(y)``, one
    cast to x's dtype; with ``sums`` the int32 sums."""
    _check(x, wq, wscale, b, xscale, groups)
    xs = xscale.float().reshape(())
    acc = F.conv2d(quantize_act(x, xs).double(), wq.double(), None, stride,
                   pad, 1, groups)
    if sums:
        return acc.to(torch.int32)
    s = (xs * wscale.float())[:, None, None]
    y = fma32(acc.float(), s, b.float()[:, None, None])
    if act:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _planes_vec(t: torch.Tensor) -> bool:
    """Whether the planes of an NCHW tensor are contiguous and 16-byte
    aligned in groups of 16 bytes, so that a kernel moves them 16 bytes
    at a time."""
    n, c, h, w = t.shape
    group = 16 // t.element_size()
    sn, sc, sh, sw = t.stride()
    return (sw == 1 and sh == w and (h * w) % group == 0 and sc % group == 0
            and sn % group == 0 and t.data_ptr() % 16 == 0)


def quantize_codes_plain(x: torch.Tensor,
                         xscale: torch.Tensor) -> torch.Tensor:
    """What the kernel's quantize pass writes: the codes of
    :func:`quantize_act`, channel-minor, (N, H, W, c_pitch(C)) int8 with
    zero codes past C."""
    n, c, h, w = x.shape
    codes = torch.zeros((n, h, w, c_pitch(c)), dtype=torch.int8,
                        device=x.device)
    codes[..., :c] = quantize_act(x, xscale).permute(0, 2, 3, 1)
    return codes


def quantize_codes(x: torch.Tensor, xscale: torch.Tensor) -> torch.Tensor:
    """K8's quantize pass alone on a CUDA tensor (the codes that
    :func:`conv_s8` writes before its conv), :func:`quantize_codes_plain`
    on a CPU tensor: NCHW x -> (N, H, W, c_pitch(C)) int8. Counts no
    launch: for the tests and the profiling tool."""
    if x.device.type == "cpu":
        return quantize_codes_plain(x, xscale)
    if x.dim() != 4 or x.dtype not in _DTYPES or x.device.type != "cuda" or (
            xscale.device != x.device or xscale.numel() != 1):
        raise ValueError(f"quantize_codes wants x (N, C, H, W) float32 or "
                         f"bfloat16 and one xscale on one CUDA device; got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    n, c, h, w = x.shape
    codes = torch.empty((n, h, w, c_pitch(c)), dtype=torch.int8,
                        device=x.device)
    xs = xscale.float().reshape(1).contiguous()
    err = _build.lib().ssyt_conv_s8_quantize(
        x.data_ptr(), xs.data_ptr(), codes.data_ptr(), n, h, w, c,
        *x.stride(), c_pitch(c), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_codes")
    return codes


def pack_s8(wq: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """K8's weights: for groups 1, ``(k * k * ci_pad / 32, 2, co_pad, 16)``
    int8: per K chunk of 32 codes over (ky, kx, ci), its two halves of 16,
    each a row of 16 codes per output channel (wgmma's no-swizzle K-major
    layout of B: a block's channels of one half are one contiguous run),
    C_in padded with zeros to ``ci_pad = c_pitch(C_in)`` per tap and C_out
    to ``co_pad``, a multiple of 64; for a depthwise conv, ``(C, k * k)``."""
    c_out, cig, k, _ = wq.shape
    if is_depthwise(wq, groups):
        return wq.reshape(c_out, k * k).contiguous()
    ci_pad, co_pad = _pads(wq)
    blob = torch.zeros((co_pad, k * k, ci_pad), dtype=torch.int8,
                       device=wq.device)
    blob[:c_out, :, :cig] = wq.permute(0, 2, 3, 1).reshape(c_out, k * k, cig)
    chunks = k * k * ci_pad // BK
    return blob.reshape(co_pad, chunks, 2, 16).permute(1, 2, 0, 3).contiguous()


def _pads(wq: torch.Tensor) -> tuple[int, int]:
    """(ci_pad, co_pad) of the tensor-core form's packed weights."""
    return c_pitch(wq.shape[1]), -(-wq.shape[0] // CO_ALIGN) * CO_ALIGN


def conv_s8(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
            b: torch.Tensor, xscale: torch.Tensor, *, stride: int = 1,
            pad: int = 0, groups: int = 1, act: bool = True,
            packed: torch.Tensor | None = None,
            sums: bool = False) -> torch.Tensor:
    """K8 on a CUDA tensor, :func:`conv_s8_plain` on a CPU tensor: NCHW x
    -> (N, C_out, H_out, W_out) in x's dtype (int32 sums with ``sums``).
    ``xscale`` is one float32 on x's device; ``packed`` is
    :func:`pack_s8` of ``wq`` (packed here where not given)."""
    _check(x, wq, wscale, b, xscale, groups)
    if x.device.type == "cpu":
        return conv_s8_plain(x, wq, wscale, b, xscale, stride=stride,
                             pad=pad, groups=groups, act=act, sums=sums)
    if x.device.type != "cuda":
        raise ValueError(f"conv_s8: unsupported device {x.device}")
    if any(t.device != x.device for t in (wq, wscale, b, xscale)):
        raise ValueError("conv_s8: x, wq, wscale, b and xscale must be on "
                         "one device")
    n, c_in, h, w = x.shape
    c_out, _, k, _ = wq.shape
    h_out = (h + 2 * pad - k) // stride + 1
    w_out = (w + 2 * pad - k) // stride + 1
    depthwise = is_depthwise(wq, groups)
    blob = pack_s8(wq, groups) if packed is None else packed
    ci_pad, co_pad = _pads(wq)
    want = ((c_out, k * k) if depthwise
            else (k * k * ci_pad // BK, 2, co_pad, 16))
    if (blob.dtype != torch.int8 or blob.device != x.device
            or tuple(blob.shape) != want or not blob.is_contiguous()
            or blob.data_ptr() % 16):
        raise ValueError(f"conv_s8: packed weights {tuple(blob.shape)} "
                         f"{blob.dtype} are not pack_s8 of {tuple(wq.shape)} "
                         f"(groups {groups}) on {x.device}")
    out = torch.empty((n, c_out, h_out, w_out),
                      dtype=torch.int32 if sums else x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch(x, blob, wscale, b, xscale, out, k=k, stride=stride, pad=pad,
           depthwise=depthwise, act=act, bn=n_tile(c_out))
    conv_s8.launches += 1
    return out


conv_s8.launches = 0


def launch(x: torch.Tensor, blob: torch.Tensor, wscale: torch.Tensor,
           b: torch.Tensor, xscale: torch.Tensor, out: torch.Tensor, *,
           k: int, stride: int, pad: int, depthwise: bool, act: bool,
           bn: int) -> None:
    """The C entry on checked CUDA tensors (:func:`conv_s8` checks them)
    into ``out`` (int32 sums where ``out`` is int32): for groups 1 the
    quantize pass into a scratch of codes, then the conv with ``bn``
    output channels per block of the tensor-core form; for a depthwise
    conv the one launch, tiled by :func:`dw_plan`. Counts no launch: the
    profiling tool calls it with each tile of ``N_TILES``."""
    n, c_in, h, w = x.shape
    _, c_out, h_out, w_out = out.shape
    ws = wscale.float().contiguous()
    bk = b.float().contiguous()
    xs = xscale.float().reshape(1).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tail = (int(act), int(out.dtype == torch.int32), _DTYPES[x.dtype],
            int(_planes_vec(out)), stream)
    if depthwise:
        cg, bh = dw_plan(n, c_out, h_out, w_out, k=k, stride=stride, w=w,
                         pad=pad)
        err = _build.lib().ssyt_conv_s8_dw(
            x.data_ptr(), blob.data_ptr(), ws.data_ptr(), bk.data_ptr(),
            xs.data_ptr(), out.data_ptr(), n, h, w, c_in, h_out, w_out,
            *x.stride(), *out.stride(), k, stride, pad, cg, bh, *tail)
    else:
        pitch = c_pitch(c_in)
        codes = torch.empty((n, h, w, pitch), dtype=torch.int8,
                            device=x.device)
        err = _build.lib().ssyt_conv_s8(
            x.data_ptr(), blob.data_ptr(), ws.data_ptr(), bk.data_ptr(),
            xs.data_ptr(), codes.data_ptr(), out.data_ptr(), n, h, w, c_in,
            c_out, h_out, w_out, *x.stride(), *out.stride(), k, stride, pad,
            pitch, blob.shape[2], bn, *tail)
    _build.check(err, "conv_s8")
