"""YOLOv8 / YOLO11 detection, segmentation and pose models as PyTorch
modules, NCHW.

Counterpart of ``strongsort_yolo_tpu/models/yolo.py`` (v5 and v7 are in
``yolov5.py`` and ``yolov7.py``):
C2f (v8) or C3k2 + C2PSA (v11) backbones, SPPF, PAN neck, anchor-free
decoupled heads with DFL ``reg_max=16`` at strides 8/16/32, the v11
depthwise class tower, the pose keypoint towers and the segment mask
towers with their prototype net. The forward returns the JAX
``model_apply`` dict of raw head outputs, anchors row-major per level:
``box_logits`` (B, A, 4*reg_max) and ``cls_logits`` (B, A, nc) in the
compute dtype, and in float32 ``kpt_raw`` (B, A, nk), or ``mask_coef``
(B, A, nm) and ``proto`` (B, nm, Hm, Wm) NCHW (:func:`model_apply` gives
it in the JAX layout, (B, Hm, Wm, nm)).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch import nn

from strongsort_yolo_tpu_torch.models.common import (
    C2PSA,
    C2f,
    C3k2,
    Conv,
    SPPF,
    fuse_conv_bn,
    init_conv2d_bias_,
    init_conv_,
    upsample2x,
)
from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import eligible

# family -> scale -> (depth_mult, width_mult, max_channels)
SCALES = {
    "v8": {
        "n": (0.33, 0.25, 1024),
        "s": (0.33, 0.50, 1024),
        "m": (0.67, 0.75, 768),
        "l": (1.00, 1.00, 512),
        "x": (1.00, 1.25, 512),
    },
    "v11": {
        "n": (0.50, 0.25, 1024),
        "s": (0.50, 0.50, 1024),
        "m": (0.50, 1.00, 512),
        "l": (1.00, 1.00, 512),
        "x": (1.00, 1.50, 512),
    },
}


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    family: str = "v8"  # "v8" | "v11"
    scale: str = "n"  # n/s/m/l/x
    task: str = "detect"  # detect | segment | pose
    nc: int = 80
    reg_max: int = 16
    nm: int = 32  # mask coefficients (segment)
    npr: int = 256  # proto channels before width scaling (segment)
    kpt: tuple[int, int] = (17, 3)  # keypoints (pose)
    strides: tuple[int, ...] = (8, 16, 32)

    def ch(self, c: int) -> int:
        """Apply width multiple + max-channel cap, rounded to 8."""
        _, w, maxc = SCALES[self.family][self.scale]
        return max(int(round(min(c, maxc) * w / 8)) * 8, 8)

    def depth(self, n: int) -> int:
        d, _, _ = SCALES[self.family][self.scale]
        return max(round(n * d), 1)

    @property
    def nk(self) -> int:
        return self.kpt[0] * self.kpt[1]

    @property
    def head_ch(self) -> tuple[int, int, int]:
        """(P3, P4, P5) channel counts feeding the heads."""
        return (self.ch(256), self.ch(512), self.ch(1024))


def build_model(name: str):
    """Parse a model name such as 'yolov8n' or 'yolo11n-pose' into its
    YoloConfig; 'yolov5*' names give a ``Yolov5Config``
    (:func:`~.yolov5.build_v5`), 'yolov7*' a ``Yolov7Config``."""
    base = name.lower().removesuffix(".pt")
    if base.startswith("yolov5"):
        from strongsort_yolo_tpu_torch.models.yolov5 import build_v5

        return build_v5(name)
    if base.startswith("yolov7"):
        from strongsort_yolo_tpu_torch.models.yolov7 import Yolov7Config

        return Yolov7Config()
    task = "detect"
    if base.endswith("-seg"):
        task, base = "segment", base.removesuffix("-seg")
    elif base.endswith("-pose"):
        task, base = "pose", base.removesuffix("-pose")
    if base.startswith("yolov8"):
        family, scale = "v8", base.removeprefix("yolov8")
    elif base.startswith("yolo11") or base.startswith("yolov11"):
        family = "v11"
        scale = base.removeprefix("yolov11").removeprefix("yolo11")
    else:
        raise ValueError(f"unknown model name: {name}")
    if scale not in "nsmlx" or len(scale) != 1:
        raise ValueError(f"unknown scale in model name: {name}")
    return YoloConfig(family=family, scale=scale, task=task)


def _c3k_default(cfg: YoloConfig) -> bool:
    """v11: C3k2 takes C3k units on the m/l/x scales, bottlenecks on n/s."""
    return cfg.scale in ("m", "l", "x")


def _stage_block(cfg: YoloConfig, c_in: int, c_out: int, n: int, *,
                 shortcut: bool, c3k: bool, fused: bool, e: float = 0.5):
    """The per-family CSP unit: C2f for v8, C3k2 for v11."""
    if cfg.family == "v8":
        return C2f(c_in, c_out, n, shortcut=shortcut, e=e, fused=fused)
    return C3k2(c_in, c_out, n, shortcut=shortcut, c3k=c3k, e=e, fused=fused)


class Backbone(nn.Module):
    """NCHW image -> (P3, P4, P5). v11 widens stages 1-2 early (e=0.25,
    P3 carries ch(512)), forces C3k units in stages 3-4 and ends in
    C2PSA after SPPF."""

    def __init__(self, cfg: YoloConfig, fused: bool):
        super().__init__()
        ch = cfg.ch
        v11 = cfg.family == "v11"
        if v11:
            reps = (cfg.depth(2),) * 4
        else:
            reps = (cfg.depth(3), cfg.depth(6), cfg.depth(6), cfg.depth(3))
        c3k = _c3k_default(cfg)
        e12 = 0.25 if v11 else 0.5
        c1, c2 = (ch(256), ch(512)) if v11 else (ch(128), ch(256))
        kw = {"shortcut": True, "fused": fused}
        self.stem = Conv(3, ch(64), 3, 2, fused=fused)
        self.down1 = Conv(ch(64), ch(128), 3, 2, fused=fused)
        self.stage1 = _stage_block(cfg, ch(128), c1, reps[0], c3k=c3k, e=e12, **kw)
        self.down2 = Conv(c1, ch(256), 3, 2, fused=fused)
        self.stage2 = _stage_block(cfg, ch(256), c2, reps[1], c3k=c3k, e=e12, **kw)
        self.down3 = Conv(c2, ch(512), 3, 2, fused=fused)
        self.stage3 = _stage_block(cfg, ch(512), ch(512), reps[2],
                                   c3k=v11 or c3k, **kw)
        self.down4 = Conv(ch(512), ch(1024), 3, 2, fused=fused)
        self.stage4 = _stage_block(cfg, ch(1024), ch(1024), reps[3],
                                   c3k=v11 or c3k, **kw)
        self.sppf = SPPF(ch(1024), ch(1024), fused=fused)
        self.c2psa = C2PSA(ch(1024), cfg.depth(2), fused=fused) if v11 else None

    def forward(self, x):
        x = self.stage1(self.down1(self.stem(x)))
        p3 = self.stage2(self.down2(x))
        p4 = self.stage3(self.down3(p3))
        p5 = self.sppf(self.stage4(self.down4(p4)))
        if self.c2psa is not None:
            p5 = self.c2psa(p5)
        return p3, p4, p5


class Neck(nn.Module):
    """PAN neck: top-down then bottom-up fusion."""

    def __init__(self, cfg: YoloConfig, fused: bool):
        super().__init__()
        ch = cfg.ch
        v11 = cfg.family == "v11"
        n = cfg.depth(2) if v11 else cfg.depth(3)
        c3k = _c3k_default(cfg)
        p3_ch = ch(512) if v11 else ch(256)
        kw = {"shortcut": False, "fused": fused, "c3k": c3k}
        self.td1 = _stage_block(cfg, ch(1024) + ch(512), ch(512), n, **kw)
        self.td2 = _stage_block(cfg, ch(512) + p3_ch, ch(256), n, **kw)
        self.bu1_conv = Conv(ch(256), ch(256), 3, 2, fused=fused)
        self.bu1 = _stage_block(cfg, ch(256) + ch(512), ch(512), n, **kw)
        self.bu2_conv = Conv(ch(512), ch(512), 3, 2, fused=fused)
        self.bu2 = _stage_block(cfg, ch(512) + ch(1024), ch(1024), n,
                                **{**kw, "c3k": v11 or c3k})

    def forward(self, feats):
        p3, p4, p5 = feats
        t4 = self.td1(torch.cat([upsample2x(p5), p4], dim=1))
        n3 = self.td2(torch.cat([upsample2x(t4), p3], dim=1))
        n4 = self.bu1(torch.cat([self.bu1_conv(n3), t4], dim=1))
        n5 = self.bu2(torch.cat([self.bu2_conv(n4), p5], dim=1))
        return n3, n4, n5


class Branch(nn.Module):
    """Conv-Conv-Conv2d tower of the heads; ``dw=True`` is the v11
    depthwise class tower (3x3 depthwise, 1x1, 3x3 depthwise, 1x1)."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, fused: bool,
                 dw: bool = False):
        super().__init__()
        self.dw = dw
        if dw:
            self.a_dw = Conv(c_in, c_in, 3, fused=fused, groups=c_in)
            self.a = Conv(c_in, c_mid, 1, fused=fused)
            self.b_dw = Conv(c_mid, c_mid, 3, fused=fused, groups=c_mid)
            self.b = Conv(c_mid, c_mid, 1, fused=fused)
        else:
            self.a = Conv(c_in, c_mid, 3, fused=fused)
            self.b = Conv(c_mid, c_mid, 3, fused=fused)
        self.out = Conv(c_mid, c_out, 1, act=False, fused=True)

    def forward(self, x):
        if self.dw:
            x = self.b(self.b_dw(self.a(self.a_dw(x))))
        else:
            x = self.b(self.a(x))
        return self.out(x)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w, C), anchors row-major."""
    return x.flatten(2).transpose(1, 2)


class DetectHead(nn.Module):
    def __init__(self, cfg: YoloConfig, fused: bool):
        super().__init__()
        ch = cfg.head_ch
        c2 = max(16, ch[0] // 4, cfg.reg_max * 4)
        c3 = max(ch[0], min(cfg.nc, 100))
        dw = cfg.family == "v11"
        self.box = nn.ModuleList(
            Branch(c, c2, 4 * cfg.reg_max, fused) for c in ch
        )
        self.cls = nn.ModuleList(Branch(c, c3, cfg.nc, fused, dw) for c in ch)

    def forward(self, feats):
        box_out = [_rows(box(f)) for f, box in zip(feats, self.box)]
        cls_out = [_rows(cls(f)) for f, cls in zip(feats, self.cls)]
        return torch.cat(box_out, dim=1), torch.cat(cls_out, dim=1)


class Proto(nn.Module):
    """The segment head's prototype net: P3 features -> (B, nm, 2*h3,
    2*w3) masks (160x160 at 640)."""

    def __init__(self, cfg: YoloConfig, fused: bool):
        super().__init__()
        c_ = cfg.ch(cfg.npr)
        self.cv1 = Conv(cfg.head_ch[0], c_, 3, fused=fused)
        self.cv2 = Conv(c_, c_, 3, fused=fused)
        self.cv3 = Conv(c_, cfg.nm, 1, fused=fused)

    def forward(self, x):
        return self.cv3(self.cv2(upsample2x(self.cv1(x))))


class YoloModel(nn.Module):
    """(B, 3, H, W) in [0, 1] -> the dict of raw head outputs (module
    docstring)."""

    def __init__(self, cfg: YoloConfig, *, fused: bool = False):
        super().__init__()
        if cfg.family not in ("v8", "v11") or cfg.task not in (
                "detect", "segment", "pose"):
            raise NotImplementedError(
                f"no {cfg.family} {cfg.task} model in the port")
        self.cfg = cfg
        self.fused = fused
        self.backbone = Backbone(cfg, fused)
        self.neck = Neck(cfg, fused)
        self.detect = DetectHead(cfg, fused)
        ch = cfg.head_ch
        if cfg.task == "segment":
            c4 = max(ch[0] // 4, cfg.nm)
            self.proto = Proto(cfg, fused)
            self.mask = nn.ModuleList(Branch(c, c4, cfg.nm, fused) for c in ch)
        elif cfg.task == "pose":
            c4 = max(ch[0] // 4, cfg.nk)
            self.kpt = nn.ModuleList(Branch(c, c4, cfg.nk, fused) for c in ch)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        feats = self.neck(self.backbone(x))
        box, cls = self.detect(feats)
        out = {"box_logits": box, "cls_logits": cls}
        if self.cfg.task == "segment":
            out["mask_coef"] = torch.cat(
                [_rows(m(f)) for f, m in zip(feats, self.mask)], 1).float()
            out["proto"] = self.proto(feats[0]).float()
        elif self.cfg.task == "pose":
            out["kpt_raw"] = torch.cat(
                [_rows(k(f)) for f, k in zip(feats, self.kpt)], 1).float()
        return out

    def use_conv_kernel(self) -> None:
        """Compute every conv that the K7 rule picks with K7 (the route of
        ``Pipeline(conv_kernel=True)``): call on the fused float32 model,
        before its cast (:meth:`Conv.use_conv_kernel`)."""
        if not self.fused:
            raise ValueError("the conv kernel takes the fused model")
        for mod in self.modules():
            if isinstance(mod, Conv):
                mod.use_conv_kernel()


class Pick(NamedTuple):
    """A conv that the K7 rule picks, with its input plane and channels."""

    name: str
    h: int
    w: int
    c_in: int
    c_out: int
    k: int
    act: bool


def kernel_picks(model: YoloModel, input_hw: tuple[int, int]) -> list[Pick]:
    """The convs that the K7 rule picks at this input size, in forward
    order (shapes only: a forward of a copy on the meta device)."""
    meta = copy.deepcopy(model).to("meta")
    picks = []

    def note(name):
        def hook(mod, args):
            n, c, h, w = args[0].shape
            k = mod.w.shape[-1]
            if eligible((n, h, w, c), k, mod.stride, mod.groups, 1):
                picks.append(Pick(name, h, w, c, mod.w.shape[0], k, mod.act))
        return hook

    for name, mod in meta.named_modules():
        if isinstance(mod, Conv):
            mod._k7_src = mod._k7 = None
            mod.register_forward_pre_hook(note(name))
    with torch.no_grad():
        meta(torch.empty((1, 3, *input_hw), device="meta"))
    return picks


def init_model(
    cfg: YoloConfig, generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> YoloModel:
    """Random unfused model with the JAX ``init_model`` distributions and
    the detection-prior biases: box bias 1.0, class bias set so the
    initial objectness matches ~5 objects per 640 px image per level."""
    model = YoloModel(cfg)
    for name, mod in model.named_modules():
        if isinstance(mod, Conv):
            if name.endswith(".out"):
                init_conv2d_bias_(mod, generator)
            else:
                init_conv_(mod, generator)
    with torch.no_grad():
        for i, s in enumerate(cfg.strides):
            model.detect.box[i].out.b.fill_(1.0)
            model.detect.cls[i].out.b.fill_(
                math.log(5.0 / cfg.nc / (640.0 / s) ** 2)
            )
    return model.to(device)


def model_apply(model: YoloModel, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Forward of (B, 3, H, W) in [0, 1], computed in the dtype of the
    model's parameters -> the JAX ``model_apply`` dict in float32 and in
    the JAX layouts: 'box_logits' (B, A, 4*reg_max), 'cls_logits' (B, A,
    nc), and 'kpt_raw' (B, A, nk), or 'mask_coef' (B, A, nm) and 'proto'
    (B, Hm, Wm, nm)."""
    out = model(x.to(model.detect.box[0].out.w.dtype))
    out = {k: v.float() for k, v in out.items()}
    if "proto" in out:
        out["proto"] = out["proto"].permute(0, 2, 3, 1)
    return out


def feat_hw(input_hw: tuple[int, int], strides=(8, 16, 32)):
    """Per-level (h, w) for an input size."""
    h, w = input_hw
    return [(h // s, w // s) for s in strides]


def fuse_model(model: nn.Module) -> nn.Module:
    """A copy of ``model`` (a YoloModel, Yolov5Model or Yolov7Model) with
    every BN folded into its conv and every RepConv in its deploy form
    (:func:`~.yolov7.fuse_repconv`)."""
    from strongsort_yolo_tpu_torch.models.yolov7 import RepConv, fuse_repconv

    if model.fused and getattr(model, "rep_deploy", True):
        return model
    fused = type(model)(model.cfg, fused=True)
    src = dict(model.named_modules())
    for name, mod in fused.named_modules():
        old = src.get(name)  # None inside a RepConv that was not deployed
        if isinstance(old, RepConv):
            mod.load_state_dict(fuse_repconv(old).state_dict())
        elif isinstance(old, Conv):
            mod.load_state_dict(fuse_conv_bn(old).state_dict())
    return fused.to(next(model.parameters()).device)


def detector_family(cfg) -> tuple[type[nn.Module], Callable]:
    """(model class, random init) of ``cfg``'s family: Yolov5Config,
    Yolov7Config, else v8 / v11 (a YoloConfig or any config with its
    fields)."""
    from strongsort_yolo_tpu_torch.models import yolov5, yolov7

    return {
        yolov5.Yolov5Config: (yolov5.Yolov5Model, yolov5.init_yolov5),
        yolov7.Yolov7Config: (yolov7.Yolov7Model, yolov7.init_yolov7),
    }.get(type(cfg), (YoloModel, init_model))
