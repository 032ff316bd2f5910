"""OSNet, the omni-scale ReID embedder of StrongSORT, as NCHW modules.

Counterpart of ``strongsort_yolo_tpu/models/osnet.py`` (the torchreid
``osnet_x*`` layout): 7x7/2 conv stem, 3x3/2 max-pool, three stages of
two OS blocks with 1x1 conv + 2x2 average-pool transitions, a final 1x1
conv, global average pooling and an fc head (Linear -> BatchNorm1d ->
ReLU), L2-normalised. A checkpoint's keys follow the JAX tree leaf for
leaf, joined with dots (``b2a.streams.0.0.dw.w``), with conv weights
OIHW; loading folds every BatchNorm into its conv, so the served model
holds a weight and a bias per conv. ``OSNet(fused=False)``, the form the
trainer differentiates (the JAX ``osnet_apply`` on its tree), holds the
checkpoint itself: its state_dict has the checkpoint's keys.

Not the YOLO ``Conv``: OSNet's BatchNorm uses eps 1e-5 and ReLU (or no
activation in the linear 1x1 convs). The input normalisation runs as a
plain ``(x - mean) / std`` before the stem (the JAX package folds it into
the stem conv, a TPU layout device). Frames are BGR: a model built with
``channel_order="bgr"`` holds its stem weights and mean/std reversed
once, at load, so crops cut from BGR frames embed like RGB crops.

:meth:`OSNet.use_fused_stages` switches the three backbone stages to the
fused stage kernel K6 (``ops/cuda/osnet_kernel.os_stage``), as
``osnet_apply(fused=True)`` does in the JAX package; the stem, max-pool
and fc head stay as they are.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import (
    os_stage,
    stage_specs,
    stage_weights,
)

BN_EPS = 1e-5  # torch BatchNorm default (torchreid checkpoints)

VARIANTS = {
    "osnet_x1_0": 1.0,
    "osnet_x0_75": 0.75,
    "osnet_x0_5": 0.5,
    "osnet_x0_25": 0.25,
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)  # RGB
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class OsnetConfig:
    variant: str = "osnet_x0_25"
    feat_dim: int = 512
    crop_hw: tuple[int, int] = (128, 64)

    @property
    def channels(self) -> tuple[int, int, int, int]:
        m = VARIANTS[self.variant]
        return tuple(int(c * m) for c in (64, 256, 384, 512))


class ConvBias(nn.Module):
    """Conv2d with a bias, then ReLU when ``relu``. Checkpoint keys:
    ``w``, ``b`` (the lite conv's pointwise, the gate's fcs)."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, stride: int = 1, *,
                 groups: int = 1, relu: bool = False, bias: bool = True):
        super().__init__()
        self.stride, self.pad, self.groups = stride, k // 2, groups
        self.relu = relu
        self.w = nn.Parameter(torch.empty(c_out, c_in // groups, k, k))
        if bias:
            self.b = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.w, self.b, self.stride, self.pad, 1, self.groups)
        return F.relu(y) if self.relu else y


def _add_bn(mod: nn.Module, c: int) -> None:
    """Give ``mod`` the BN tensors of the checkpoint: ``bn_scale`` and
    ``bn_bias`` as parameters, ``bn_mean`` and ``bn_var`` as buffers (the
    YOLO ``Conv``'s split; a trainer takes both, ``train.trained_tensors``)."""
    mod.bn_scale = nn.Parameter(torch.ones(c))
    mod.bn_bias = nn.Parameter(torch.zeros(c))
    mod.register_buffer("bn_mean", torch.zeros(c))
    mod.register_buffer("bn_var", torch.ones(c))


def _bn(mod: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """Inference BN of ``mod``'s tensors (eps 1e-5) over dim 1 of ``y``,
    as ``y * scale + (bn_bias - bn_mean * scale)``, the JAX ``bn_act``."""
    scale = mod.bn_scale * torch.rsqrt(mod.bn_var + BN_EPS)
    shape = (1, -1) + (1,) * (y.dim() - 2)
    return y * scale.view(shape) + (mod.bn_bias - mod.bn_mean * scale).view(shape)


class ConvBN(ConvBias):
    """Conv2d (no bias) -> BatchNorm (eps 1e-5, inference statistics) ->
    ReLU when ``relu`` (torchreid ConvLayer / Conv1x1 / Conv1x1Linear).
    Checkpoint keys: ``w`` and ``bn_scale``/``bn_bias``/``bn_mean``/
    ``bn_var``. ``fused`` (serving) holds the BN folded into ``w`` and
    ``b``; unfused (training) holds the checkpoint's tensors and computes
    the BN, as the JAX ``osnet_apply`` differentiates it."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, stride: int = 1, *,
                 groups: int = 1, relu: bool = True, fused: bool = True):
        super().__init__(c_in, c_out, k, stride, groups=groups, relu=relu,
                         bias=fused)
        self.fused = fused
        if not fused:
            _add_bn(self, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return super().forward(x)
        y = _bn(self, F.conv2d(x, self.w, None, self.stride, self.pad, 1,
                               self.groups))
        return F.relu(y) if self.relu else y


class FcHead(nn.Module):
    """Linear (a 1x1 conv weight, the JAX layout) -> BatchNorm1d.
    Checkpoint keys: ``lin.w``, ``lin.b`` and ``bn.bn_*``. ``fused`` holds
    the BN folded into ``w`` and ``b``; unfused holds the checkpoint's
    ``lin`` and ``bn``."""

    def __init__(self, c_in: int, feat_dim: int, *, fused: bool = True):
        super().__init__()
        self.fused = fused
        if fused:
            self.w = nn.Parameter(torch.empty(feat_dim, c_in, 1, 1))
            self.b = nn.Parameter(torch.zeros(feat_dim))
        else:
            self.lin = ConvBias(c_in, feat_dim)
            self.bn = nn.Module()
            _add_bn(self.bn, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return F.linear(x, self.w.flatten(1), self.b)
        return _bn(self.bn, F.linear(x, self.lin.w.flatten(1), self.lin.b))


class LiteConv(nn.Module):
    """LightConv3x3: linear 1x1 pointwise with a bias and no BN ->
    depthwise 3x3 -> BN -> ReLU."""

    def __init__(self, c: int, *, fused: bool = True):
        super().__init__()
        self.pw = ConvBias(c, c)
        self.dw = ConvBN(c, c, 3, groups=c, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dw(self.pw(x))


class Gate(nn.Module):
    """Channel gate shared by the four streams of a block: global mean ->
    fc -> ReLU -> fc -> sigmoid -> scale (reduction 16)."""

    def __init__(self, c: int):
        super().__init__()
        r = max(c // 16, 1)
        self.fc1 = ConvBias(c, r)
        self.fc2 = ConvBias(r, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class OSBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, streams: int = 4, *,
                 fused: bool = True):
        super().__init__()
        mid = c_out // 4
        self.conv1 = ConvBN(c_in, mid, 1, fused=fused)
        self.gate = Gate(mid)
        self.conv3 = ConvBN(mid, c_out, 1, relu=False, fused=fused)
        self.streams = nn.ModuleList(
            nn.ModuleList(LiteConv(mid, fused=fused) for _ in range(t))
            for t in range(1, streams + 1)
        )
        self.down = ConvBN(c_in, c_out, 1, relu=False, fused=fused) if (
            c_in != c_out) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        agg = None
        for convs in self.streams:
            s = y
            for conv in convs:
                s = conv(s)
            s = self.gate(s)
            agg = s if agg is None else agg + s
        res = x if self.down is None else self.down(x)
        return F.relu(self.conv3(agg) + res)


class OSNet(nn.Module):
    """(M, 3, 128, 64) crops in [0, 1] -> (M, feat_dim) float32
    L2-normalised embeddings. ``fused`` (serving) holds every BN folded
    (:func:`osnet_from_state_dict`); unfused, the model's state_dict is a
    checkpoint (:func:`checkpoint_keys`) and the BNs are computed, the
    form a trainer differentiates (``tools/train_osnet``)."""

    def __init__(self, cfg: OsnetConfig = OsnetConfig(), *,
                 channel_order: str = "rgb", fused: bool = True):
        super().__init__()
        if channel_order not in ("rgb", "bgr"):
            raise ValueError(f"channel_order {channel_order!r}")
        self.cfg = cfg
        self.channel_order = channel_order
        c1, c2, c3, c4 = cfg.channels
        order = slice(None, None, -1 if channel_order == "bgr" else 1)
        # float32 whatever the model's dtype: kept out of the buffers,
        # which .to(dtype) would round
        self._norm = tuple(
            torch.tensor(v[order], dtype=torch.float32).reshape(1, 3, 1, 1)
            for v in (IMAGENET_MEAN, IMAGENET_STD)
        )
        f = {"fused": fused}
        self.fused = fused
        self.stem = ConvBN(3, c1, 7, 2, **f)
        self.b2a, self.b2b = OSBlock(c1, c2, **f), OSBlock(c2, c2, **f)
        self.t2 = ConvBN(c2, c2, 1, **f)
        self.b3a, self.b3b = OSBlock(c2, c3, **f), OSBlock(c3, c3, **f)
        self.t3 = ConvBN(c3, c3, 1, **f)
        self.b4a, self.b4b = OSBlock(c3, c4, **f), OSBlock(c4, c4, **f)
        self.conv5 = ConvBN(c4, c4, 1, **f)
        self.fc = FcHead(c4, cfg.feat_dim, **f)
        self._specs = stage_specs(cfg.channels, cfg.crop_hw)
        self._stages = None  # packed K6 weights, once use_fused_stages ran

    def use_fused_stages(self, dtype: torch.dtype) -> None:
        """Run the backbone stages as three K6 launches in compute
        ``dtype``. The stage weights are packed now, from this model's
        float32 weights: call it before casting the model, whose cast
        would round the biases and tap weights that K6 keeps in float32.
        The packed weights are kept out of the buffers, which ``.to(dtype)``
        would round, and follow the crops' device."""
        if not self.fused:
            raise ValueError("the stage kernel takes the fused OSNet")
        self._stages = tuple(stage_weights(self, i, dtype)
                             for i in range(len(self._specs)))

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        dt = self.stem.w.dtype
        if self._norm[0].device != crops.device:
            self._norm = tuple(t.to(crops.device) for t in self._norm)
        mean, std = self._norm
        x = ((crops.float() - mean) / std).to(dt)
        x = F.max_pool2d(self.stem(x), 3, 2, 1)  # pads with -inf
        if self._stages is not None:
            if self._stages[0].mats.device != x.device:
                self._stages = tuple(w.to(x.device) for w in self._stages)
            for spec, w in zip(self._specs, self._stages):
                x = os_stage(x, w, spec)
        else:
            x = self.b2b(self.b2a(x))
            x = F.avg_pool2d(self.t2(x), 2)
            x = self.b3b(self.b3a(x))
            x = F.avg_pool2d(self.t3(x), 2)
            x = self.b4b(self.b4a(x))
            x = self.conv5(x).mean((2, 3))
        feat = F.relu(self.fc(x)).float()
        return feat / torch.clamp(feat.norm(dim=-1, keepdim=True), min=1e-12)


_BN = ("bn_scale", "bn_bias", "bn_mean", "bn_var")


def _checkpoint_layout(model: OSNet):
    """-> [(module, name prefix, weight key, bias key or None, BN prefix
    or None)] of every conv: where the checkpoint keeps its tensors."""
    out = []
    for name, mod in model.named_modules():
        p = name + "."
        if isinstance(mod, FcHead):
            out.append((mod, p, p + "lin.w", p + "lin.b", p + "bn."))
        elif isinstance(mod, ConvBN):
            out.append((mod, p, p + "w", None, p))
        elif isinstance(mod, ConvBias):
            out.append((mod, p, p + "w", p + "b", None))
    return out


def checkpoint_keys(cfg: OsnetConfig = OsnetConfig()) -> set[str]:
    """The keys of an OSNet checkpoint (the JAX tree's paths joined with
    dots, BN statistics beside each conv) that
    :func:`osnet_from_state_dict` takes: the unfused model's."""
    return set(OSNet(cfg, fused=False).state_dict())


def osnet_from_state_dict(
    sd: dict[str, torch.Tensor], cfg: OsnetConfig = OsnetConfig(), *,
    channel_order: str = "rgb",
) -> OSNet:
    """An OSNet holding the checkpoint ``sd`` (:func:`checkpoint_keys`;
    RGB-convention weights, as torchreid and the JAX package keep them).
    Every BN is folded into its conv's weight and bias here, in float32,
    and ``channel_order="bgr"`` reverses the stem's input channels, both
    once."""
    want = checkpoint_keys(cfg)
    if set(sd) != want:
        missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
        raise ValueError(f"OSNet checkpoint does not match {cfg}: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    model = OSNet(cfg, channel_order=channel_order)
    fused = {}
    for _, p, w_key, b_key, bn in _checkpoint_layout(model):
        w = sd[w_key].float()
        b = sd[b_key].float() if b_key else torch.zeros(w.shape[0])
        if bn:
            scale, bias, mean, var = (sd[bn + k].float() for k in _BN)
            scale = scale * torch.rsqrt(var + BN_EPS)
            w = w * scale[:, None, None, None]
            b = (b - mean) * scale + bias
        fused[p + "w"], fused[p + "b"] = w, b
    if channel_order == "bgr":
        fused["stem.w"] = fused["stem.w"].flip(1)
    model.load_state_dict(fused)
    return model


def init_osnet(cfg: OsnetConfig, g: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights in the JAX ``init_osnet`` distributions (He-normal
    convs, unit BN, N(0, 1/fan_in) biased convs with zero bias, the lite
    pointwise N(0, 2/c_in) with zero bias) -> a checkpoint state_dict."""
    model = OSNet(cfg)
    for mod in model.modules():
        if isinstance(mod, (ConvBias, FcHead)):
            c_out, c_in_g, k, _ = mod.w.shape
            gain = 2.0 if isinstance(mod, ConvBN) else 1.0
            mod.w.data = (torch.randn(mod.w.shape, generator=g)
                          * math.sqrt(gain / (c_in_g * k * k)))
    for mod in model.modules():
        if isinstance(mod, LiteConv):
            c = mod.pw.w.shape[1]
            mod.pw.w.data = (torch.randn(mod.pw.w.shape, generator=g)
                             * math.sqrt(2.0 / c))
    sd = {}
    for mod, _, w_key, b_key, bn in _checkpoint_layout(model):
        sd[w_key] = mod.w.detach().clone()
        if b_key:
            sd[b_key] = torch.zeros(mod.w.shape[0])
        if bn:
            for k, v in zip(_BN, (1.0, 0.0, 0.0, 1.0)):
                sd[bn + k] = torch.full((mod.w.shape[0],), v)
    return sd
