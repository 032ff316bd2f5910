"""The conv layer of the reference models, weight specs, the int8 round
trip of the control and the operation counter."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Opts:
    """How a forward runs: ``dtype`` is the precision the configuration
    states (activations, weights and biases rounded to it, products
    summed by the library in float32); ``int8`` rounds every conv's input
    (per tensor) and weight (per output channel) to int8 and back, the
    control's precision below bfloat16; ``macs`` collects each conv's
    multiply-adds."""

    int8: bool = False
    macs: list | None = None
    dtype: torch.dtype = torch.float32


def fake_int8(x: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    """Symmetric int8 round trip: scale amax / 127, round, clamp."""
    if per_channel:
        amax = x.abs().flatten(1).amax(1).view(-1, *([1] * (x.dim() - 1)))
    else:
        amax = x.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


@dataclasses.dataclass
class Spec:
    """One weight: key, shape and how it is drawn: ``std`` of a normal
    draw (0 for a constant ``fill``)."""

    key: str
    shape: tuple[int, ...]
    std: float = 0.0
    fill: float = 0.0


class Conv:
    """conv2d with a bias, then ``act`` ("silu", "relu" or None).
    ``std_gain``: the weight's draw is N(0, gain / fan_in), times
    ``w_scale`` (a folded unit BN)."""

    def __init__(self, name: str, c_in: int, c_out: int, k: int = 1,
                 s: int = 1, *, act: str | None = "silu", groups: int = 1,
                 pad: int | None = None, std_gain: float = 2.0,
                 w_scale: float = 1.0, bias: bool = True, quant: bool = True):
        self.name, self.c_in, self.c_out, self.k, self.s = name, c_in, c_out, k, s
        self.act, self.groups = act, groups
        self.pad = k // 2 if pad is None else pad
        self.std = math.sqrt(std_gain / (c_in // groups * k * k)) * w_scale
        self.bias, self.quant = bias, quant

    def specs(self):
        yield Spec(self.name + ".w", (self.c_out, self.c_in // self.groups,
                                      self.k, self.k), std=self.std)
        if self.bias:
            yield Spec(self.name + ".b", (self.c_out,))

    def __call__(self, P, x: torch.Tensor, o: Opts) -> torch.Tensor:
        w = P[self.name + ".w"]
        b = P.get(self.name + ".b") if self.bias else None
        y = conv(x, w, b, self.s, self.pad, self.groups, o, quant=self.quant)
        if o.macs is not None:
            o.macs.append(y[0].numel() * (self.c_in // self.groups)
                          * self.k * self.k)
        if self.act == "silu":
            return F.silu(y)
        if self.act == "relu":
            return F.relu(y)
        return y


def conv(x, w, b, stride, pad, groups, o: Opts, *, quant: bool = True):
    """F.conv2d at the forward's precision: in ``o.dtype``, or with int8
    round trips of input and weight (summed in float32, then rounded to
    ``o.dtype``)."""
    dt = o.dtype
    if o.int8 and quant:
        x, w = fake_int8(x.float()), fake_int8(w.float(), per_channel=True)
        y = F.conv2d(x, w, None if b is None else b.float(), stride, pad, 1, groups)
        return y.to(dt)
    return F.conv2d(x.to(dt), w.to(dt), None if b is None else b.to(dt),
                    stride, pad, 1, groups)


def specs_of(*layers):
    for layer in layers:
        yield from layer.specs()


def maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(x, k, 1, k // 2)


def up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")
