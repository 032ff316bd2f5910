"""Shared YOLOv8 / YOLO11 blocks as PyTorch modules, NCHW.

Counterpart of ``strongsort_yolo_tpu/models/common.py`` (Conv+BN+SiLU
with groups, Bottleneck, C2f, C3, C3k2, SPPF, the v11 position-sensitive
attention Attention / PSABlock / C2PSA, nearest 2x upsample; not the
int8 path). Parameter names follow the JAX parameter tree leaf for leaf
(``w``, ``b``, ``bn_scale``, ``bn_bias``, ``bn_mean``, ``bn_var``; lists
become ``ModuleList``s), so a state_dict key is the JAX path joined with
dots. Weights are OIHW where the JAX package keeps HWIO.

A fused :class:`Conv` on which :meth:`Conv.use_conv_kernel` ran computes
the convs that the K7 rule (``ops/cuda/conv_kernel.eligible``) picks with
K7 (``conv_act_nchw``): the counterpart of the JAX package's
``tools/prof/conv_kernel.conv_act`` entry point and its rule.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import (
    conv_act_nchw, default_form, eligible, pack_mma,
)

BN_EPS = 1e-3


def autopad(k: int, d: int = 1) -> int:
    """'same' padding for odd kernels."""
    return (d * (k - 1) + 1) // 2


def bn_act(
    conv: "Conv", y: torch.Tensor, *, act: bool = True
) -> torch.Tensor:
    """The post-conv epilogue of an unfused :class:`Conv`: inference BN,
    then SiLU."""
    scale = conv.bn_scale * torch.rsqrt(conv.bn_var + BN_EPS)
    bias = conv.bn_bias - conv.bn_mean * scale
    y = y * scale.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]
    return F.silu(y) if act else y


class Conv(nn.Module):
    """Conv2d -> BN (inference statistics) -> SiLU.

    ``fused=True`` holds the BN folded into ``w`` and a bias ``b``
    (:func:`fuse_conv_bn`); with ``act=False`` that is also the plain
    conv-with-bias of the head output layers. ``groups`` as in
    ``F.conv2d`` (the v11 depthwise convs: groups = channels).
    """

    def __init__(
        self, c_in: int, c_out: int, k: int = 1, stride: int = 1, *,
        act: bool = True, fused: bool = False, groups: int = 1,
    ):
        super().__init__()
        self.stride, self.pad, self.act, self.fused = stride, autopad(k), act, fused
        self.groups = groups
        self.w = nn.Parameter(torch.empty(c_out, c_in // groups, k, k))
        if fused:
            self.b = nn.Parameter(torch.zeros(c_out))
        else:
            self.bn_scale = nn.Parameter(torch.ones(c_out))
            self.bn_bias = nn.Parameter(torch.zeros(c_out))
            self.register_buffer("bn_mean", torch.zeros(c_out))
            self.register_buffer("bn_var", torch.ones(c_out))
        self._k7_src = None  # float32 (w, b) for K7, once use_conv_kernel ran
        self._k7 = None  # (w, b, mma blob or None) on the activations' device

    def use_conv_kernel(self) -> None:
        """Compute this conv with K7 wherever its input is ``eligible``.
        Its weight flattened as K7 takes it, (k * k * C_in, C_out), and
        its bias are kept now, in float32: call it before casting the
        model, whose cast would round the bias that K7 adds in float32.
        They are kept out of the module's buffers and follow the
        activations' device; the weight is rounded to their dtype there,
        and packed for K7's ``mma`` form where that dtype takes it."""
        if not self.fused:
            raise ValueError("the conv kernel takes fused convs (BN folded)")
        c_out, c_in, k, _ = self.w.shape
        w = self.w.detach().float().permute(2, 3, 1, 0).reshape(k * k * c_in, c_out)
        self._k7_src = (w.contiguous(), self.b.detach().float().clone())
        self._k7 = None

    def _takes_kernel(self, x: torch.Tensor) -> bool:
        n, c, h, w = x.shape
        return self._k7_src is not None and eligible(
            (n, h, w, c), self.w.shape[-1], self.stride, self.groups, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._takes_kernel(x):
            if self._k7 is None or self._k7[0].device != x.device or (
                    self._k7[0].dtype != x.dtype):
                w, b = self._k7_src
                k = self.w.shape[-1]
                packed = (pack_mma(w.to(x.device), k)
                          if default_form(x.dtype) == "mma" else None)
                self._k7 = (w.to(x.device, x.dtype), b.to(x.device), packed)
            w, b, packed = self._k7
            return conv_act_nchw(x, w, b, k=self.w.shape[-1], act=self.act,
                                 packed=packed)
        if self.fused:
            y = F.conv2d(x, self.w, self.b, self.stride, self.pad, 1, self.groups)
            return F.silu(y) if self.act else y
        y = F.conv2d(x, self.w, None, self.stride, self.pad, 1, self.groups)
        return bn_act(self, y, act=self.act)


def init_conv_(conv: Conv, g: torch.Generator) -> None:
    """He-normal weight, unit BN (the JAX ``init_conv`` distribution)."""
    c_out, c_in, k, _ = conv.w.shape
    std = math.sqrt(2.0 / (c_in * k * k))
    with torch.no_grad():
        conv.w.copy_(torch.randn(conv.w.shape, generator=g) * std)


def init_conv2d_bias_(conv: Conv, g: torch.Generator) -> None:
    """N(0, 1/fan_in) weight, zero bias (the JAX ``init_conv2d_bias``)."""
    c_out, c_in, k, _ = conv.w.shape
    std = math.sqrt(1.0 / (c_in * k * k))
    with torch.no_grad():
        conv.w.copy_(torch.randn(conv.w.shape, generator=g) * std)
        conv.b.zero_()


def fuse_conv_bn(conv: Conv) -> Conv:
    """A fused copy of ``conv`` with its BN folded into weight and bias."""
    if conv.fused:
        return conv
    c_out, c_in, k, _ = conv.w.shape
    out = Conv(c_in * conv.groups, c_out, k, conv.stride, act=conv.act,
               fused=True, groups=conv.groups)
    with torch.no_grad():
        scale = conv.bn_scale * torch.rsqrt(conv.bn_var + BN_EPS)
        out.w.copy_(conv.w * scale[:, None, None, None])
        out.b.copy_(conv.bn_bias - conv.bn_mean * scale)
    return out.to(conv.w.device)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, shortcut: bool,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_mid = int(c_out * e)
        self.shortcut = shortcut
        self.cv1 = Conv(c_in, c_mid, 3, fused=fused)
        self.cv2 = Conv(c_mid, c_out, 3, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Split-transform-concat CSP block (v8 backbone/neck unit)."""

    def __init__(self, c_in: int, c_out: int, n: int, *, shortcut: bool,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_mid = int(c_out * e)
        self.cv1 = Conv(c_in, 2 * c_mid, 1, fused=fused)
        self.cv2 = Conv((2 + n) * c_mid, c_out, 1, fused=fused)
        self.m = nn.ModuleList(
            Bottleneck(c_mid, c_mid, shortcut=shortcut, e=1.0, fused=fused)
            for _ in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = list(self.cv1(x).chunk(2, dim=1))
        for block in self.m:
            outs.append(block(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class C3(nn.Module):
    """The CSP block with 3x3 bottlenecks that is the C3k unit of a v11
    C3k2 (the JAX ``init_c3`` with ``bottleneck_k1=3``; v5's 1x1 form is
    not ported)."""

    def __init__(self, c_in: int, c_out: int, n: int, *, shortcut: bool,
                 fused: bool = False):
        super().__init__()
        c_mid = c_out // 2
        self.cv1 = Conv(c_in, c_mid, 1, fused=fused)
        self.cv2 = Conv(c_in, c_mid, 1, fused=fused)
        self.cv3 = Conv(2 * c_mid, c_out, 1, fused=fused)
        self.m = nn.ModuleList(
            Bottleneck(c_mid, c_mid, shortcut=shortcut, e=1.0, fused=fused)
            for _ in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for block in self.m:
            a = block(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3kUnit(nn.Module):
    """One inner unit of a C3k2 with ``c3k``: a C3 of two bottlenecks with
    3x3 first convs, under the JAX tree's ``c3k`` key."""

    def __init__(self, c: int, *, shortcut: bool, fused: bool = False):
        super().__init__()
        self.c3k = C3(c, c, 2, shortcut=shortcut, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c3k(x)


class C3k2(nn.Module):
    """The v11 CSP unit: a C2f whose inner units are C3k blocks
    (``c3k=True``) or bottlenecks of half width."""

    def __init__(self, c_in: int, c_out: int, n: int, *, shortcut: bool,
                 c3k: bool, e: float = 0.5, fused: bool = False):
        super().__init__()
        c_mid = int(c_out * e)
        self.cv1 = Conv(c_in, 2 * c_mid, 1, fused=fused)
        self.cv2 = Conv((2 + n) * c_mid, c_out, 1, fused=fused)
        self.m = nn.ModuleList(
            C3kUnit(c_mid, shortcut=shortcut, fused=fused) if c3k
            else Bottleneck(c_mid, c_mid, shortcut=shortcut, e=0.5, fused=fused)
            for _ in range(n)
        )

    forward = C2f.forward


class SPPF(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, k: int = 5, fused: bool = False):
        super().__init__()
        c_mid = c_in // 2
        self.k = k
        self.cv1 = Conv(c_in, c_mid, 1, fused=fused)
        self.cv2 = Conv(c_mid * 4, c_out, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        p1 = F.max_pool2d(y, self.k, 1, self.k // 2)
        p2 = F.max_pool2d(p1, self.k, 1, self.k // 2)
        p3 = F.max_pool2d(p2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class Attention(nn.Module):
    """Position-sensitive multi-head attention of the v11 PSA block: qkv
    and proj are 1x1 convs, pe a 3x3 depthwise positional conv. Heads,
    key width and scale follow from the channel count, as in the JAX
    ``attention_apply``; the two products and the softmax are plain
    ``torch.matmul`` and ``softmax`` (XLA computes them in the JAX
    package, outside any kernel)."""

    def __init__(self, dim: int, num_heads: int, *, fused: bool = False):
        super().__init__()
        head_dim = dim // num_heads
        nh_kd = head_dim // 2 * num_heads
        self.qkv = Conv(dim, dim + 2 * nh_kd, 1, act=False, fused=fused)
        self.proj = Conv(dim, dim, 1, act=False, fused=fused)
        self.pe = Conv(dim, dim, 3, act=False, fused=fused, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, hh, ww = x.shape
        heads = max(c // 64, 1)
        head_dim = c // heads
        key_dim = head_dim // 2
        qkv = self.qkv(x).reshape(n, heads, 2 * key_dim + head_dim, hh * ww)
        q, k, v = qkv.split([key_dim, key_dim, head_dim], dim=2)
        attn = torch.matmul(q.transpose(-2, -1), k) * key_dim**-0.5
        attn = attn.softmax(dim=-1)  # (n, heads, L queries, L keys)
        out = torch.matmul(v, attn.transpose(-2, -1)).reshape(n, c, hh, ww)
        return self.proj(out + self.pe(v.reshape(n, c, hh, ww)))


class PSABlock(nn.Module):
    def __init__(self, dim: int, *, fused: bool = False):
        super().__init__()
        self.attn = Attention(dim, max(dim // 64, 1), fused=fused)
        self.ffn1 = Conv(dim, 2 * dim, 1, fused=fused)
        self.ffn2 = Conv(2 * dim, dim, 1, act=False, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    """v11's attention stage after SPPF: split, n PSA blocks on one half,
    concat, 1x1."""

    def __init__(self, c: int, n: int, *, fused: bool = False):
        super().__init__()
        c_mid = c // 2
        self.cv1 = Conv(c, 2 * c_mid, 1, fused=fused)
        self.cv2 = Conv(2 * c_mid, c, 1, fused=fused)
        self.m = nn.ModuleList(PSABlock(c_mid, fused=fused) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, dim=1)
        for block in self.m:
            b = block(b)
        return self.cv2(torch.cat([a, b], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample (neck top-down path)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
