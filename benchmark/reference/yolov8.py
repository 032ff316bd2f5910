"""YOLOv8 (ultralytics ``cfg/models/v8/yolov8.yaml``) detect model at a
scale, float32 NCHW: C2f backbone, SPPF, PAN neck, the anchor-free
decoupled head with DFL (reg_max 16) at strides 8/16/32. Every BN is
folded. Keys are the program's state dict names."""

from __future__ import annotations

import math

import torch

from reference.nn import Conv, maxpool_same, specs_of, up2, Opts

SCALES = {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024),
          "m": (0.67, 0.75, 768), "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)}
STRIDES = (8, 16, 32)
REG_MAX = 16
BN_FOLD = 1.0 / math.sqrt(1.0 + 1e-3)


def _conv(name, c_in, c_out, k=1, s=1):
    return Conv(name, c_in, c_out, k, s, w_scale=BN_FOLD)


class C2f:
    def __init__(self, name, c_in, c_out, n, shortcut):
        c = int(c_out * 0.5)
        self.shortcut = shortcut
        self.cv1 = _conv(f"{name}.cv1", c_in, 2 * c)
        self.cv2 = _conv(f"{name}.cv2", (2 + n) * c, c_out)
        self.m = [(_conv(f"{name}.m.{i}.cv1", c, c, 3),
                   _conv(f"{name}.m.{i}.cv2", c, c, 3)) for i in range(n)]
        self.layers = [self.cv1, self.cv2] + [c for pair in self.m for c in pair]

    def __call__(self, P, x, o):
        outs = list(self.cv1(P, x, o).chunk(2, 1))
        for a, b in self.m:
            y = b(P, a(P, outs[-1], o), o)
            outs.append(outs[-1] + y if self.shortcut else y)
        return self.cv2(P, torch.cat(outs, 1), o)


class Sppf:
    def __init__(self, name, c_in, c_out):
        self.cv1 = _conv(f"{name}.cv1", c_in, c_in // 2)
        self.cv2 = _conv(f"{name}.cv2", c_in // 2 * 4, c_out)
        self.layers = [self.cv1, self.cv2]

    def __call__(self, P, x, o):
        y = [self.cv1(P, x, o)]
        for _ in range(3):
            y.append(maxpool_same(y[-1], 5))
        return self.cv2(P, torch.cat(y, 1), o)


class Branch:
    def __init__(self, name, c_in, c_mid, c_out):
        self.a = _conv(f"{name}.a", c_in, c_mid, 3)
        self.b = _conv(f"{name}.b", c_mid, c_mid, 3)
        self.out = Conv(f"{name}.out", c_mid, c_out, act=None, std_gain=1.0,
                        quant=False)
        self.layers = [self.a, self.b, self.out]

    def __call__(self, P, x, o):
        return self.out(P, self.b(P, self.a(P, x, o), o), o)


class Model:
    """(B, 3, H, W) RGB in [0, 1] -> {"box_logits" (B, A, 4 reg_max),
    "cls_logits" (B, A, nc)} float32, anchors row-major per level."""

    kind = "dfl"

    def __init__(self, scale: str = "n", nc: int = 80):
        d, wm, maxc = SCALES[scale]
        self.nc = nc

        def ch(c):
            return max(int(round(min(c, maxc) * wm / 8)) * 8, 8)

        def depth(n):
            return max(round(n * d), 1)

        r = (depth(3), depth(6), depth(6), depth(3))
        b, n = "backbone", depth(3)
        self.layers = {
            "stem": _conv(f"{b}.stem", 3, ch(64), 3, 2),
            "down1": _conv(f"{b}.down1", ch(64), ch(128), 3, 2),
            "stage1": C2f(f"{b}.stage1", ch(128), ch(128), r[0], True),
            "down2": _conv(f"{b}.down2", ch(128), ch(256), 3, 2),
            "stage2": C2f(f"{b}.stage2", ch(256), ch(256), r[1], True),
            "down3": _conv(f"{b}.down3", ch(256), ch(512), 3, 2),
            "stage3": C2f(f"{b}.stage3", ch(512), ch(512), r[2], True),
            "down4": _conv(f"{b}.down4", ch(512), ch(1024), 3, 2),
            "stage4": C2f(f"{b}.stage4", ch(1024), ch(1024), r[3], True),
            "sppf": Sppf(f"{b}.sppf", ch(1024), ch(1024)),
            "td1": C2f("neck.td1", ch(1024) + ch(512), ch(512), n, False),
            "td2": C2f("neck.td2", ch(512) + ch(256), ch(256), n, False),
            "bu1_conv": _conv("neck.bu1_conv", ch(256), ch(256), 3, 2),
            "bu1": C2f("neck.bu1", ch(256) + ch(512), ch(512), n, False),
            "bu2_conv": _conv("neck.bu2_conv", ch(512), ch(512), 3, 2),
            "bu2": C2f("neck.bu2", ch(512) + ch(1024), ch(1024), n, False),
        }
        head = (ch(256), ch(512), ch(1024))
        c2 = max(16, head[0] // 4, REG_MAX * 4)
        c3 = max(head[0], min(nc, 100))
        self.box = [Branch(f"detect.box.{i}", c, c2, 4 * REG_MAX)
                    for i, c in enumerate(head)]
        self.cls = [Branch(f"detect.cls.{i}", c, c3, nc)
                    for i, c in enumerate(head)]

    def specs(self):
        for layer in [*self.layers.values(), *self.box, *self.cls]:
            yield from specs_of(*getattr(layer, "layers", [layer]))

    def features(self, P, x, o):
        L = self.layers
        x = L["stage1"](P, L["down1"](P, L["stem"](P, x, o), o), o)
        p3 = L["stage2"](P, L["down2"](P, x, o), o)
        p4 = L["stage3"](P, L["down3"](P, p3, o), o)
        p5 = L["sppf"](P, L["stage4"](P, L["down4"](P, p4, o), o), o)
        t4 = L["td1"](P, torch.cat([up2(p5), p4], 1), o)
        n3 = L["td2"](P, torch.cat([up2(t4), p3], 1), o)
        n4 = L["bu1"](P, torch.cat([L["bu1_conv"](P, n3, o), t4], 1), o)
        n5 = L["bu2"](P, torch.cat([L["bu2_conv"](P, n4, o), p5], 1), o)
        return n3, n4, n5

    def __call__(self, P, x, o=None):
        o = o or Opts()
        feats = self.features(P, x, o)

        def rows(t):
            return t.flatten(2).transpose(1, 2)

        return {"box_logits": torch.cat([rows(b(P, f, o)) for b, f in
                                         zip(self.box, feats)], 1).float(),
                "cls_logits": torch.cat([rows(c(P, f, o)) for c, f in
                                         zip(self.cls, feats)], 1).float()}
