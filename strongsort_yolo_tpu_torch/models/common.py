"""Shared YOLOv5 / v7 / v8 / YOLO11 blocks as PyTorch modules, NCHW.

Counterpart of ``strongsort_yolo_tpu/models/common.py`` (Conv+BN+SiLU
with groups and an explicit padding, and its int8 mode, Bottleneck, C2f,
C3 with 1x1 or 3x3 first bottleneck convs, C3k2, SPPF, the v11
position-sensitive attention Attention / PSABlock / C2PSA, nearest 2x
upsample) and of ``models/yolov7.py``'s max-pools. Parameter names follow the JAX parameter tree leaf for leaf
(``w``, ``b``, ``bn_scale``, ``bn_bias``, ``bn_mean``, ``bn_var``; lists
become ``ModuleList``s), so a state_dict key is the JAX path joined with
dots. Weights are OIHW where the JAX package keeps HWIO.

A fused :class:`Conv` on which :meth:`Conv.use_conv_kernel` ran computes
the convs that the K7 rule (``ops/cuda/conv_kernel.eligible``) picks with
K7 (``conv_act_nchw``): the counterpart of the JAX package's
``tools/prof/conv_kernel.conv_act`` entry point and its rule.

A fused :class:`Conv` on which :meth:`Conv.quantize_int8` ran
(:func:`quantize_model`) holds ``wq`` (int8, OIHW), ``wscale`` and ``b``
(float32) and, once calibrated (:func:`calibrating`,
:func:`inject_scales`), ``xscale`` (a float32 scalar) in place of its
float weight, as the JAX package's int8 parameter dicts do, and computes
with K8 (``ops/quant.conv_int8``). Those float32 buffers keep their dtype
when the model is cast.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from strongsort_yolo_tpu_torch.ops import quant
from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import (
    conv_act_nchw, default_form, eligible, pack_mma,
)
from strongsort_yolo_tpu_torch.ops.cuda.quant_kernel import pack_s8

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
    ``F.conv2d`` (the v11 depthwise convs: groups = channels). ``pad``
    overrides the 'same' padding (v5's 6x6/2 stem takes 2). ``int8``:
    the int8 mode of :meth:`quantize_int8`, which takes precedence.
    """

    _F32 = ("wscale", "xscale", "b")  # int8 mode: kept float32 by casts

    def __init__(
        self, c_in: int, c_out: int, k: int = 1, stride: int = 1, *,
        act: bool = True, fused: bool = False, groups: int = 1,
        pad: int | None = None,
    ):
        super().__init__()
        self.stride, self.act, self.fused = stride, act, fused
        self.pad = autopad(k) if pad is None else pad
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
        self.int8 = False
        self._k8 = None  # K8's packed weights (pack_s8) on the card
        self.calib = None  # while calibrating: the dict of input amaxes
        self.tp = None  # training over a mesh: parallel/ranks.TpShard

    def quantize_int8(self) -> None:
        """Int8 mode: the float weight becomes ``wq`` and ``wscale``
        (``ops/quant.quantize_conv``, from the float32 weight: call it
        before the model is cast), ``b`` a float32 buffer, and ``xscale``
        an empty buffer until calibration fills it."""
        if not self.fused:
            raise ValueError("int8 mode takes fused convs (BN folded)")
        if self._k7_src is not None:
            raise ValueError("int8 mode and the K7 route exclude each other")
        wq, wscale = quant.quantize_conv(self.w.float())
        b = self.b.detach().float().clone()
        del self.w, self.b
        self.register_buffer("wq", wq)
        self.register_buffer("wscale", wscale)
        self.register_buffer("b", b)
        self.register_buffer("xscale", None)
        self.int8 = True
        self._k8 = None

    def drop_caches(self) -> None:
        """Forget what was derived from the weights (K7's and K8's
        packed copies); the next forward makes them anew."""
        self._k7 = self._k8 = None

    def _apply(self, fn, recurse=True):
        if not self.int8:
            return super()._apply(fn, recurse)
        keep = {n: t for n in self._F32
                if (t := self._buffers.get(n)) is not None}
        out = super()._apply(fn, recurse)
        for n, t in keep.items():  # the device of the cast, not its dtype
            self._buffers[n] = t.to(self._buffers[n].device)
        self._k8 = None
        return out

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
        if self.int8:
            if self.calib is not None:
                a, prev = quant.amax(x), self.calib.get(self)
                self.calib[self] = a if prev is None else torch.maximum(prev, a)
            if x.device.type == "cuda" and (
                    self._k8 is None or self._k8.device != x.device):
                self._k8 = pack_s8(self.wq.to(x.device), self.groups)
            return quant.conv_int8(
                x, self.wq, self.wscale, self.b, self.xscale,
                stride=self.stride, pad=self.pad, groups=self.groups,
                act=self.act, packed=self._k8)
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
        if self.tp is not None:  # training over a mesh: this rank's channels
            return self.tp.gather(self._float(self.tp.inputs(x)))
        return self._float(x)

    def _float(self, x: torch.Tensor) -> torch.Tensor:
        """The float conv. Where the tensors are float32 and ``x`` is
        narrower (a bfloat16 train step over float32 masters), the weight
        and bias are cast to ``x``'s dtype and the bias is added after
        the conv, at the JAX ``conv_apply``'s points; BN's scale and bias
        are formed in float32 and cast (:func:`bn_act`)."""
        w = self.w
        mixed = w.dtype != x.dtype
        if mixed:
            w = w.to(x.dtype)
        if self.fused:
            if mixed:
                y = F.conv2d(x, w, None, self.stride, self.pad, 1, self.groups)
                y = y + self.b.to(y.dtype)[:, None, None]
            else:
                y = F.conv2d(x, w, self.b, self.stride, self.pad, 1,
                             self.groups)
            return F.silu(y) if self.act else y
        y = F.conv2d(x, w, None, self.stride, self.pad, 1, self.groups)
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
               fused=True, groups=conv.groups, pad=conv.pad)
    with torch.no_grad():
        scale = conv.bn_scale * torch.rsqrt(conv.bn_var + BN_EPS)
        out.w.copy_(conv.w * scale[:, None, None, None])
        out.b.copy_(conv.bn_bias - conv.bn_mean * scale)
    return out.to(conv.w.device)


# the JAX quantize_model's skip markers: the detect / segment / pose heads,
# and the narrow stages the TPU package packs
SKIP_PATHS = ("detect", "head", "proto", "seg", "kpt",
              "/stem", "/down1", "/stage1", "/down2", "/stage2")


def jax_path(name: str) -> str:
    """A module's name -> its path in the JAX parameter tree ("/" + the
    state_dict prefix with "/" for ".")."""
    return "/" + name.replace(".", "/")


def quantizable(model: nn.Module) -> list[tuple[str, Conv]]:
    """(name, Conv) of every fused float conv of ``model`` whose JAX path
    holds none of :data:`SKIP_PATHS`: the convs the JAX ``quantize_model``
    quantizes in the same model's tree."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, Conv) and m.fused and not m.int8
            and not any(s in jax_path(name) for s in SKIP_PATHS)]


def quantize_model(model: nn.Module) -> int:
    """Put every conv :func:`quantizable` picks into int8 mode (in place,
    on the fused float32 model) -> how many."""
    picks = quantizable(model)
    for _, conv in picks:
        conv.quantize_int8()
    return len(picks)


def int8_convs(model: nn.Module) -> list[Conv]:
    return [m for m in model.modules() if isinstance(m, Conv) and m.int8]


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Record the input amax of every int8 conv of ``model`` that runs
    inside the block, whatever its scale -> the dict it fills (Conv ->
    0-d float32 device tensor), for :func:`inject_scales`."""
    stats, convs = {}, int8_convs(model)
    for conv in convs:
        conv.calib = stats
    try:
        yield stats
    finally:
        for conv in convs:
            conv.calib = None


def inject_scales(stats: dict) -> int:
    """Give each conv of ``stats`` its static scale (``ops/quant.
    static_scale`` of its amax) -> how many. One read of all the
    maxima."""
    convs = list(stats)
    if not convs:
        return 0
    amaxes = torch.stack([stats[c] for c in convs]).cpu().tolist()
    for conv, a in zip(convs, amaxes):
        conv.xscale = torch.tensor(quant.static_scale(a), device=conv.wq.device)
    return len(convs)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, shortcut: bool,
                 e: float = 0.5, fused: bool = False, k1: int = 3):
        super().__init__()
        c_mid = int(c_out * e)
        self.shortcut = shortcut
        self.cv1 = Conv(c_in, c_mid, k1, fused=fused)
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
    """The CSP block of YOLOv5 (bottlenecks with a 1x1 first conv,
    ``k1=1``, the JAX ``init_c3`` default) and the C3k unit of a v11 C3k2
    (``k1=3``, the JAX ``bottleneck_k1=3``)."""

    def __init__(self, c_in: int, c_out: int, n: int, *, shortcut: bool,
                 fused: bool = False, k1: int = 3):
        super().__init__()
        c_mid = c_out // 2
        self.cv1 = Conv(c_in, c_mid, 1, fused=fused)
        self.cv2 = Conv(c_in, c_mid, 1, fused=fused)
        self.cv3 = Conv(2 * c_mid, c_out, 1, fused=fused)
        self.m = nn.ModuleList(
            Bottleneck(c_mid, c_mid, shortcut=shortcut, e=1.0, fused=fused,
                       k1=k1)
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
        p1 = maxpool_same(y, self.k)
        p2 = maxpool_same(p1, self.k)
        p3 = maxpool_same(p2, self.k)
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


def maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max-pool padded with -inf to the input size (SPPF,
    and v7's SPPCSPC at k = 5, 9, 13)."""
    return F.max_pool2d(x, k, 1, k // 2)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool without padding (v7's MP transition)."""
    return F.max_pool2d(x, 2, 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample (neck top-down path)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
