"""Post-training int8 quantization: the tensor functions.

Counterpart of the tensor half of ``strongsort_yolo_tpu/ops/quant.py``:

- weights: symmetric per-output-channel int8, ``wscale[c] =
  max(max|w[c]|, 1e-8) / 127`` in float32 (:func:`quantize_conv`);
- activations: symmetric per-tensor int8, the scale either dynamic,
  ``max(max|x|, 1e-6) / 127`` over the whole batch tensor, a device
  reduction in the tick (:func:`dynamic_scale`), or static, from an
  input amax recorded on a few frames (:func:`static_scale`);
- the conv itself: K8 (``ops/cuda/quant_kernel.conv_s8``), int32 sums on
  the tensor cores, the dequantize, bias and SiLU in float32, one cast
  to the compute dtype (:func:`conv_int8`).

Which convs of a model are quantized, and their calibration, live beside
the conv module: ``models/common`` (``quantize_model``, ``calibrating``,
``inject_scales``).
"""

from __future__ import annotations

import numpy as np
import torch

from strongsort_yolo_tpu_torch.ops.cuda.quant_kernel import conv_s8


def quantize_conv(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A fused conv weight (C_out, C_in / g, k, k) -> (wq int8 of its
    shape, wscale (C_out,) float32): the JAX ``quantize_conv`` in the OIHW
    layout, the division a true one."""
    w = w.detach().float()
    wscale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-8) / torch.full(
        (), 127.0, device=w.device)
    wq = torch.clamp(torch.round(w / wscale[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), wscale


def amax(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` over the whole tensor, a 0-d float32 tensor on x's
    device."""
    return x.detach().abs().amax().float()


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-6) / 127`` over the whole tensor, float32, on x's
    device (no host read)."""
    a = amax(x)
    return torch.clamp_min(a, 1e-6) / torch.full_like(a, 127.0)


def static_scale(amax_value: float) -> np.float32:
    """The calibrated scale of a recorded input amax: ``float32(max(amax,
    1e-6) / 127)`` computed in double, as the JAX ``inject_scales`` does
    (its ``headroom`` is 1 in every caller)."""
    return np.float32(max(amax_value, 1e-6) / 127.0)


def conv_int8(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
              b: torch.Tensor, xscale: torch.Tensor | None, *, stride: int,
              pad: int, groups: int, act: bool,
              packed: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX ``conv_int8_apply`` on NCHW x: the static ``xscale`` where
    given, else the dynamic scale of x, then K8 (its plain version on a
    CPU tensor)."""
    if xscale is None:
        xscale = dynamic_scale(x)
    return conv_s8(x, wq, wscale, b, xscale, stride=stride, pad=pad,
                   groups=groups, act=act, packed=packed)
