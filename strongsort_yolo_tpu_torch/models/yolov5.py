"""YOLOv5 as a PyTorch module, NCHW, with its two heads.

Counterpart of ``strongsort_yolo_tpu/models/yolov5.py``:

- classic (anchor-based): per level a 1x1 conv to ``3 * (5 + nc)``
  channels, cast to float32 before the sigmoid, decoded with the COCO
  anchor priors (``xy = (2 sig - 0.5 + grid) * stride``, ``wh = (2 sig)^2
  * anchor``) into xyxy boxes in input pixels, scores ``obj * cls``;
- ``u`` (the ultralytics re-release): the same backbone and neck with
  v8's anchor-free DFL head (:class:`~.yolo.DetectHead`).

Layout: a 6x6/2 stem with padding 2, C3 stages with 1x1-first
bottlenecks (depths 3-6-9-3 before scaling), SPPF; a PAN neck with 1x1
lateral convs before each upsample. Module names follow the JAX
parameter tree, so a state_dict key is the JAX path joined with dots.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from strongsort_yolo_tpu_torch.models.common import (
    C3,
    Conv,
    SPPF,
    init_conv2d_bias_,
    init_conv_,
    upsample2x,
)
from strongsort_yolo_tpu_torch.models.yolo import DetectHead

V5_SCALES = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}

# COCO anchor priors, (w, h) pixels at 640, per level P3/P4/P5
V5_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)


@dataclasses.dataclass(frozen=True)
class Yolov5Config:
    scale: str = "n"
    nc: int = 80
    anchor_free: bool = False  # True = the "u" variant (v8 DFL head)
    reg_max: int = 16
    strides: tuple[int, ...] = (8, 16, 32)
    task: str = "detect"  # the v5 backend detects only

    family = "v5"  # the DFL head's tower choice (no v11 depthwise tower)

    def ch(self, c: int) -> int:
        _, w = V5_SCALES[self.scale]
        return max(int(round(c * w / 8)) * 8, 8)

    def depth(self, n: int) -> int:
        d, _ = V5_SCALES[self.scale]
        return max(round(n * d), 1)

    @property
    def head_ch(self) -> tuple[int, int, int]:
        return (self.ch(256), self.ch(512), self.ch(1024))


def build_v5(name: str) -> Yolov5Config:
    """'yolov5n' / 'yolov5su' etc. -> config."""
    base = name.lower().removesuffix(".pt").removeprefix("yolov5")
    anchor_free = base.endswith("u")
    scale = base.removesuffix("u")
    if scale not in "nsmlx" or len(scale) != 1:
        raise ValueError(f"unknown yolov5 scale: {name}")
    return Yolov5Config(scale=scale, anchor_free=anchor_free)


class AnchorHead(nn.Module):
    """The anchor-based Detect of v5 and v7: per level a 1x1 conv with
    bias to ``na * (5 + nc)`` channels, decoded with the level's anchor
    priors -> ``{"boxes" (B, A, 4) xyxy in input pixels, "scores" (B, A,
    nc)}`` float32, anchors ordered (row, column, prior) within a level.

    ``sigmoid_f32``: v5 casts the raw outputs to float32 before the
    sigmoid; v7 takes the sigmoid in the compute dtype and casts only the
    four box channels and the scores (the JAX functions' rounding points).
    """

    def __init__(self, head_ch, nc: int, anchors, strides, *,
                 sigmoid_f32: bool):
        super().__init__()
        self.nc, self.na = nc, len(anchors[0])
        self.strides = tuple(strides)
        self.sigmoid_f32 = sigmoid_f32
        self.m = nn.ModuleList(
            Conv(c, self.na * (5 + nc), 1, act=False, fused=True)
            for c in head_ch
        )
        # integers, so that a cast of the model to bfloat16 leaves them alone
        # (373 and 459 have no bfloat16 value)
        self.register_buffer(
            "anchors", torch.tensor(anchors, dtype=torch.int32),
            persistent=False)

    def forward(self, feats) -> dict[str, torch.Tensor]:
        boxes_all, scores_all = [], []
        for i, (f, conv) in enumerate(zip(feats, self.m)):
            raw = conv(f)
            n, _, h, w = raw.shape
            raw = raw.reshape(n, self.na, 5 + self.nc, h, w).permute(0, 3, 4, 1, 2)
            if self.sigmoid_f32:
                raw = raw.float()
            sig = torch.sigmoid(raw)  # (n, h, w, na, 5 + nc)
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=raw.device),
                torch.arange(w, dtype=torch.float32, device=raw.device),
                indexing="ij",
            )
            grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
            anchor = self.anchors[i].float()[None, None, None]
            s = float(self.strides[i])
            xy = (sig[..., :2].float() * 2.0 - 0.5 + grid) * s
            wh = (sig[..., 2:4].float() * 2.0) ** 2 * anchor
            boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
            scores = (sig[..., 4:5] * sig[..., 5:]).float()
            boxes_all.append(boxes.reshape(n, -1, 4))
            scores_all.append(scores.reshape(n, -1, self.nc))
        return {"boxes": torch.cat(boxes_all, 1),
                "scores": torch.cat(scores_all, 1)}


class Yolov5Model(nn.Module):
    """(B, 3, H, W) in [0, 1] -> ``{"boxes", "scores"}`` (classic head) or
    ``{"box_logits", "cls_logits"}`` float32 (``u``), the JAX
    ``yolov5_apply`` contract."""

    def __init__(self, cfg: Yolov5Config, *, fused: bool = False):
        super().__init__()
        self.cfg, self.fused = cfg, fused
        ch, d = cfg.ch, cfg.depth

        def c3(c_in, c_out, n, shortcut):
            return C3(c_in, c_out, n, shortcut=shortcut, fused=fused, k1=1)

        def conv(c_in, c_out, k, s=1, **kw):
            return Conv(c_in, c_out, k, s, fused=fused, **kw)

        self.stem = conv(3, ch(64), 6, 2, pad=2)
        self.down1 = conv(ch(64), ch(128), 3, 2)
        self.stage1 = c3(ch(128), ch(128), d(3), True)
        self.down2 = conv(ch(128), ch(256), 3, 2)
        self.stage2 = c3(ch(256), ch(256), d(6), True)
        self.down3 = conv(ch(256), ch(512), 3, 2)
        self.stage3 = c3(ch(512), ch(512), d(9), True)
        self.down4 = conv(ch(512), ch(1024), 3, 2)
        self.stage4 = c3(ch(1024), ch(1024), d(3), True)
        self.sppf = SPPF(ch(1024), ch(1024), fused=fused)
        self.lat5 = conv(ch(1024), ch(512), 1)
        self.td1 = c3(ch(1024), ch(512), d(3), False)
        self.lat4 = conv(ch(512), ch(256), 1)
        self.td2 = c3(ch(512), ch(256), d(3), False)
        self.bu1_conv = conv(ch(256), ch(256), 3, 2)
        self.bu1 = c3(ch(512), ch(512), d(3), False)
        self.bu2_conv = conv(ch(512), ch(512), 3, 2)
        self.bu2 = c3(ch(1024), ch(1024), d(3), False)
        if cfg.anchor_free:
            self.detect = DetectHead(cfg, fused)
        else:
            self.detect = AnchorHead(cfg.head_ch, cfg.nc, V5_ANCHORS,
                                     cfg.strides, sigmoid_f32=True)

    def features(self, x: torch.Tensor):
        """Backbone + neck -> (n3, n4, n5)."""
        x = self.stage1(self.down1(self.stem(x)))
        p3 = self.stage2(self.down2(x))
        p4 = self.stage3(self.down3(p3))
        p5 = self.sppf(self.stage4(self.down4(p4)))
        l5 = self.lat5(p5)
        t4 = self.td1(torch.cat([upsample2x(l5), p4], dim=1))
        l4 = self.lat4(t4)
        n3 = self.td2(torch.cat([upsample2x(l4), p3], dim=1))
        n4 = self.bu1(torch.cat([self.bu1_conv(n3), l4], dim=1))
        n5 = self.bu2(torch.cat([self.bu2_conv(n4), l5], dim=1))
        return n3, n4, n5

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        feats = self.features(x)
        if isinstance(self.detect, AnchorHead):
            return self.detect(feats)
        box, cls = self.detect(feats)
        return {"box_logits": box.float(), "cls_logits": cls.float()}


def init_yolov5(
    cfg: Yolov5Config, generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> Yolov5Model:
    """Random unfused model with the JAX ``init_yolov5`` distributions:
    He-normal convs with unit BN, N(0, 1/fan_in) head output convs with
    zero biases."""
    model = Yolov5Model(cfg)
    head_out = {f"detect.m.{i}" for i in range(3)}
    for name, mod in model.named_modules():
        if isinstance(mod, Conv):
            if name.endswith(".out") or name in head_out:
                init_conv2d_bias_(mod, generator)
            else:
                init_conv_(mod, generator)
    return model.to(device)
