"""K8: the int8 conv of post-training quantization (``csrc/conv_s8.cu``),
its wrapper :func:`conv_s8`, its plain PyTorch version
:func:`conv_s8_plain` and the weight packing :func:`pack_s8`.

It replaces no Pallas kernel: its counterpart is the JAX package's
``ops/quant.py:41`` ``conv_int8_apply``, an XLA convolution of int8 codes
with int32 sums (the TPU's int8 matrix unit) and its dequantize / bias /
SiLU epilogue. PyTorch has no int8 convolution on CUDA, so the port's is
written for the H100's int8 tensor cores.

What it computes, on NCHW activations, one launch per conv:
``xq = clip(round(x / xscale), -127, 127)`` (x widened to float32, a true
division, half to even), int32 sums of ``xq * wq`` over (ky, kx, ci),
then ``y = fma(sum, xscale * wscale[c], b[c])`` rounded once, SiLU
(``y * sigmoid(y)``) if ``act``, one cast to x's dtype. The sums are
exact, so the kernel and the plain version agree on them bit for bit,
and on every output where the epilogue rounds alike: always with
``act=False``, and with the SiLU where the plain version runs
``torch.sigmoid`` on the card (the same ``1 / (1 + expf(-y))``).
Groups 1 (tensor cores) or depthwise (groups = C_in = C_out, CUDA
cores); any k, stride and padding.

Bound (chip_smoke): the larger of the bytes (x read once, the weights
once, the output written once) over 3.35 TB/s and 2 x MACs over 1,979
TOPS (int8 dense).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from strongsort_yolo_tpu_torch.ops.crops import fma32
from strongsort_yolo_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BK, BN = 32, 64  # the tensor-core form's K step and output-channel tile


def is_depthwise(wq: torch.Tensor, groups: int) -> bool:
    return groups > 1 and wq.shape[1] == 1 and wq.shape[0] == groups


def _pads(wq: torch.Tensor) -> tuple[int, int]:
    """(ci_pad, co_pad) of the tensor-core form: C_in / groups to a
    multiple of BK, C_out to a multiple of BN."""
    return -(-wq.shape[1] // BK) * BK, -(-wq.shape[0] // BN) * BN


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


def pack_s8(wq: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """K8's weights: for groups 1, ``(co_pad, k * k * ci_pad)`` int8, a
    row per output channel over (tap, ci), C_in padded with zeros to a
    multiple of 32 per tap and C_out to a multiple of 64; for a depthwise
    conv, ``(C, k * k)``."""
    c_out, cig, k, _ = wq.shape
    if is_depthwise(wq, groups):
        return wq.reshape(c_out, k * k).contiguous()
    ci_pad, co_pad = _pads(wq)
    blob = torch.zeros((co_pad, k * k, ci_pad), dtype=torch.int8,
                       device=wq.device)
    blob[:c_out, :, :cig] = wq.permute(0, 2, 3, 1).reshape(c_out, k * k, cig)
    return blob.reshape(co_pad, k * k * ci_pad)


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
    want = (c_out, k * k) if depthwise else (co_pad, k * k * ci_pad)
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
    ws = wscale.float().contiguous()
    bk = b.float().contiguous()
    xs = xscale.float().reshape(1).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().ssyt_conv_s8(
        x.data_ptr(), blob.data_ptr(), ws.data_ptr(), bk.data_ptr(),
        xs.data_ptr(), out.data_ptr(), n, h, w, c_in, c_out, h_out, w_out,
        *x.stride(), *out.stride(), k, stride, pad, int(depthwise), ci_pad,
        co_pad, int(act), int(sums), _DTYPES[x.dtype], stream)
    conv_s8.launches += 1
    _build.check(err, "conv_s8")
    return out


conv_s8.launches = 0
