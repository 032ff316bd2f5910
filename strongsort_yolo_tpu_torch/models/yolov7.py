"""YOLOv7 (the base model) as a PyTorch module, NCHW.

Counterpart of ``strongsort_yolo_tpu/models/yolov7.py``: a backbone of
E-ELAN blocks (two 1x1 stems, a chain of four 3x3 convs tapped after
every second one, concat, 1x1 merge) with MP down-transitions (max-pool
and 1x1, beside 1x1 and 3x3/2, concatenated); a head of SPPCSPC, a PAN
with ELAN-W blocks (tapped after every inner conv), RepConv before each
output, and the anchor-based Detect at strides 8/16/32 with v7's anchor
priors (:class:`~.yolov5.AnchorHead`, its sigmoid in the compute dtype).

RepConv has its training form (3x3 conv+BN beside 1x1 conv+BN, summed,
then SiLU) and its deploy form, one 3x3 conv that :func:`fuse_repconv`
folds both branches into; :func:`fuse_yolov7` gives the deploy model
(every RepConv folded, every BN folded). The JAX package's packed stem
(``packed_prefix``, a TPU layout rewrite) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from strongsort_yolo_tpu_torch.models.common import (
    Conv,
    fuse_conv_bn,
    init_conv2d_bias_,
    init_conv_,
    maxpool2,
    maxpool_same,
    upsample2x,
)
from strongsort_yolo_tpu_torch.models.yolo import fuse_model
from strongsort_yolo_tpu_torch.models.yolov5 import AnchorHead

V7_ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)


@dataclasses.dataclass(frozen=True)
class Yolov7Config:
    nc: int = 80
    strides: tuple[int, ...] = (8, 16, 32)
    task: str = "detect"


class ELAN(nn.Module):
    """E-ELAN (``wide=False``: four c_mid inner convs, tapped after every
    second one) or ELAN-W (``wide=True``: inner convs of c_mid // 2, each
    tapped); taps concatenated last first, then the 1x1 merge."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, *, wide: bool,
                 fused: bool):
        super().__init__()
        self.wide = wide
        c_inner = c_mid // 2 if wide else c_mid
        self.cv1 = Conv(c_in, c_mid, 1, fused=fused)
        self.cv2 = Conv(c_in, c_mid, 1, fused=fused)
        self.inner = nn.ModuleList(
            Conv(c_mid if i == 0 else c_inner, c_inner, 3, fused=fused)
            for i in range(4)
        )
        n_taps = 4 if wide else 2
        self.merge = Conv(2 * c_mid + n_taps * c_inner, c_out, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(x)
        outs = [self.cv1(x), y]
        for i, conv in enumerate(self.inner):
            y = conv(y)
            if self.wide or i % 2 == 1:
                outs.append(y)
        return self.merge(torch.cat(outs[::-1], dim=1))


class MP(nn.Module):
    """Down-transition: the strided-conv path (1x1, 3x3/2) concatenated
    before the pooled one (2x2 max-pool, 1x1), the official yaml's order."""

    def __init__(self, c_in: int, c_half: int, *, fused: bool):
        super().__init__()
        self.cv1 = Conv(c_in, c_half, 1, fused=fused)
        self.cv2 = Conv(c_in, c_half, 1, fused=fused)
        self.cv3 = Conv(c_half, c_half, 3, 2, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cv3(self.cv2(x)), self.cv1(maxpool2(x))], dim=1)


class SPPCSPC(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, fused: bool):
        super().__init__()
        c_ = c_out
        self.cv1 = Conv(c_in, c_, 1, fused=fused)
        self.cv2 = Conv(c_in, c_, 1, fused=fused)
        self.cv3 = Conv(c_, c_, 3, fused=fused)
        self.cv4 = Conv(c_, c_, 1, fused=fused)
        self.cv5 = Conv(4 * c_, c_, 1, fused=fused)
        self.cv6 = Conv(c_, c_, 3, fused=fused)
        self.cv7 = Conv(2 * c_, c_out, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv4(self.cv3(self.cv1(x)))
        pools = [y] + [maxpool_same(y, k) for k in (5, 9, 13)]
        y = self.cv6(self.cv5(torch.cat(pools, dim=1)))
        return self.cv7(torch.cat([y, self.cv2(x)], dim=1))


class RepConv(nn.Module):
    """Training form (``deploy=False``): 3x3 conv+BN beside 1x1 conv+BN,
    summed, then SiLU (no identity branch: c_in != c_out at every v7 use);
    deploy form: one fused 3x3 conv + SiLU under ``fused``."""

    def __init__(self, c_in: int, c_out: int, *, deploy: bool, fused: bool):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.fused = Conv(c_in, c_out, 3, fused=True)
        else:
            self.dense = Conv(c_in, c_out, 3, act=False, fused=fused)
            self.one = Conv(c_in, c_out, 1, act=False, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return self.fused(x)
        return F.silu(self.dense(x) + self.one(x))


def fuse_repconv(rep: RepConv) -> RepConv:
    """The deploy form of ``rep``: both branches' BNs folded (eps 1e-3)
    and the 1x1 kernel zero-padded into the 3x3 one."""
    if rep.deploy:
        return rep
    dense, one = fuse_conv_bn(rep.dense), fuse_conv_bn(rep.one)
    c_out, c_in = dense.w.shape[:2]
    out = RepConv(c_in, c_out, deploy=True, fused=True)
    with torch.no_grad():
        out.fused.w.copy_(dense.w + F.pad(one.w, (1, 1, 1, 1)))
        out.fused.b.copy_(dense.b + one.b)
    return out.to(dense.w.device)


class Yolov7Model(nn.Module):
    """(B, 3, H, W) in [0, 1] -> ``{"boxes" (B, A, 4), "scores" (B, A,
    nc)}`` float32, the JAX ``yolov7_apply`` contract. ``fused``: BNs
    folded; ``rep_deploy`` (default: ``fused``): the RepConvs in their
    deploy form."""

    def __init__(self, cfg: Yolov7Config = Yolov7Config(), *,
                 fused: bool = False, rep_deploy: bool | None = None):
        super().__init__()
        self.cfg, self.fused = cfg, fused
        self.rep_deploy = fused if rep_deploy is None else rep_deploy

        def conv(c_in, c_out, k, s=1):
            return Conv(c_in, c_out, k, s, fused=fused)

        def elan(c_in, c_mid, c_out, wide=False):
            return ELAN(c_in, c_mid, c_out, wide=wide, fused=fused)

        def rep(c_in, c_out):
            return RepConv(c_in, c_out, deploy=self.rep_deploy, fused=fused)

        self.stem0 = conv(3, 32, 3)
        self.stem1 = conv(32, 64, 3, 2)
        self.stem2 = conv(64, 64, 3)
        self.down2 = conv(64, 128, 3, 2)
        self.elan2 = elan(128, 64, 256)
        self.mp3 = MP(256, 128, fused=fused)
        self.elan3 = elan(256, 128, 512)  # P3 out 512
        self.mp4 = MP(512, 256, fused=fused)
        self.elan4 = elan(512, 256, 1024)  # P4 out 1024
        self.mp5 = MP(1024, 512, fused=fused)
        self.elan5 = elan(1024, 256, 1024)  # P5 out 1024
        self.sppcspc = SPPCSPC(1024, 512, fused=fused)
        self.lat4 = conv(512, 256, 1)
        self.route4 = conv(1024, 256, 1)
        self.elan_h4 = elan(512, 256, 256, wide=True)
        self.lat3 = conv(256, 128, 1)
        self.route3 = conv(512, 128, 1)
        self.elan_h3 = elan(256, 128, 128, wide=True)  # P3 head 128
        self.mp_h4 = MP(128, 128, fused=fused)
        self.elan_h4b = elan(512, 256, 256, wide=True)  # P4 head 256
        self.mp_h5 = MP(256, 256, fused=fused)
        self.elan_h5 = elan(1024, 512, 512, wide=True)  # P5 head 512
        self.rep3 = rep(128, 256)
        self.rep4 = rep(256, 512)
        self.rep5 = rep(512, 1024)
        self.detect = AnchorHead((256, 512, 1024), cfg.nc, V7_ANCHORS,
                                 cfg.strides, sigmoid_f32=False)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        y = self.down2(self.stem2(self.stem1(self.stem0(x))))
        y = self.mp3(self.elan2(y))
        p3 = self.elan3(y)  # /8, 512
        p4 = self.elan4(self.mp4(p3))  # /16, 1024
        p5 = self.elan5(self.mp5(p4))  # /32, 1024
        spp = self.sppcspc(p5)  # 512
        up4 = upsample2x(self.lat4(spp))
        h4 = self.elan_h4(torch.cat([self.route4(p4), up4], dim=1))
        up3 = upsample2x(self.lat3(h4))
        h3 = self.elan_h3(torch.cat([self.route3(p3), up3], dim=1))
        h4b = self.elan_h4b(torch.cat([self.mp_h4(h3), h4], dim=1))
        h5 = self.elan_h5(torch.cat([self.mp_h5(h4b), spp], dim=1))
        return self.detect((self.rep3(h3), self.rep4(h4b), self.rep5(h5)))


def init_yolov7(
    cfg: Yolov7Config, generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> Yolov7Model:
    """Random training-form model with the JAX ``init_yolov7``
    distributions: He-normal convs with unit BN, N(0, 1/fan_in) head
    output convs with zero biases."""
    model = Yolov7Model(cfg)
    for name, mod in model.named_modules():
        if isinstance(mod, Conv):
            if name.startswith("detect.m."):
                init_conv2d_bias_(mod, generator)
            else:
                init_conv_(mod, generator)
    return model.to(device)


def fuse_yolov7(model: Yolov7Model) -> Yolov7Model:
    """The deploy form: every RepConv reparameterized
    (:func:`fuse_repconv`), every BN folded (``yolo.fuse_model``, which
    serves every family)."""
    return fuse_model(model)
