"""YOLOv7 (WongKinYiu/yolov7 ``cfg/deploy/yolov7.yaml``) in its deploy
form, float32 NCHW: E-ELAN backbone with MP down-transitions, SPPCSPC,
the PAN head of ELAN-W blocks, RepConv as one 3x3 conv, and the
anchor-based Detect at strides 8/16/32. Every BN is folded: a conv has
a weight and a bias. Keys are the program's state dict names."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.nn import Conv, Opts, maxpool_same, specs_of, up2

ANCHORS = (((12, 16), (19, 36), (40, 28)),
           ((36, 75), (76, 55), (72, 146)),
           ((142, 110), (192, 243), (459, 401)))
STRIDES = (8, 16, 32)
BN_FOLD = 1.0 / math.sqrt(1.0 + 1e-3)  # a unit BN folded (eps 1e-3)


def _conv(name, c_in, c_out, k=1, s=1):
    return Conv(name, c_in, c_out, k, s, w_scale=BN_FOLD)


class Elan:
    def __init__(self, name, c_in, c_mid, c_out, wide=False):
        inner = c_mid // 2 if wide else c_mid
        self.wide = wide
        self.cv1 = _conv(f"{name}.cv1", c_in, c_mid)
        self.cv2 = _conv(f"{name}.cv2", c_in, c_mid)
        self.inner = [_conv(f"{name}.inner.{i}", c_mid if i == 0 else inner,
                            inner, 3) for i in range(4)]
        taps = 4 if wide else 2
        self.merge = _conv(f"{name}.merge", 2 * c_mid + taps * inner, c_out)
        self.layers = [self.cv1, self.cv2, *self.inner, self.merge]

    def __call__(self, P, x, o):
        y = self.cv2(P, x, o)
        outs = [self.cv1(P, x, o), y]
        for i, conv in enumerate(self.inner):
            y = conv(P, y, o)
            if self.wide or i % 2 == 1:
                outs.append(y)
        return self.merge(P, torch.cat(outs[::-1], 1), o)


class MP:
    def __init__(self, name, c_in, c_half):
        self.cv1 = _conv(f"{name}.cv1", c_in, c_half)
        self.cv2 = _conv(f"{name}.cv2", c_in, c_half)
        self.cv3 = _conv(f"{name}.cv3", c_half, c_half, 3, 2)
        self.layers = [self.cv1, self.cv2, self.cv3]

    def __call__(self, P, x, o):
        return torch.cat([self.cv3(P, self.cv2(P, x, o), o),
                          self.cv1(P, F.max_pool2d(x, 2, 2), o)], 1)


class Sppcspc:
    def __init__(self, name, c_in, c_out):
        c = c_out
        self.cv = {i: _conv(f"{name}.cv{i}", *shape) for i, shape in {
            1: (c_in, c), 2: (c_in, c), 3: (c, c, 3), 4: (c, c),
            5: (4 * c, c), 6: (c, c, 3), 7: (2 * c, c_out)}.items()}
        self.layers = list(self.cv.values())

    def __call__(self, P, x, o):
        cv = self.cv
        y = cv[4](P, cv[3](P, cv[1](P, x, o), o), o)
        y = torch.cat([y] + [maxpool_same(y, k) for k in (5, 9, 13)], 1)
        y = cv[6](P, cv[5](P, y, o), o)
        return cv[7](P, torch.cat([y, cv[2](P, x, o)], 1), o)


class Model:
    """(B, 3, H, W) RGB in [0, 1] -> {"boxes" (B, A, 4) xyxy input
    pixels, "scores" (B, A, nc)} float32; anchors ordered (level, row,
    column, prior)."""

    kind = "anchor"

    def __init__(self, nc: int = 80):
        self.nc, self.na = nc, 3
        b = {
            "stem0": _conv("stem0", 3, 32, 3), "stem1": _conv("stem1", 32, 64, 3, 2),
            "stem2": _conv("stem2", 64, 64, 3), "down2": _conv("down2", 64, 128, 3, 2),
            "elan2": Elan("elan2", 128, 64, 256), "mp3": MP("mp3", 256, 128),
            "elan3": Elan("elan3", 256, 128, 512), "mp4": MP("mp4", 512, 256),
            "elan4": Elan("elan4", 512, 256, 1024), "mp5": MP("mp5", 1024, 512),
            "elan5": Elan("elan5", 1024, 256, 1024),
            "sppcspc": Sppcspc("sppcspc", 1024, 512),
            "lat4": _conv("lat4", 512, 256), "route4": _conv("route4", 1024, 256),
            "elan_h4": Elan("elan_h4", 512, 256, 256, wide=True),
            "lat3": _conv("lat3", 256, 128), "route3": _conv("route3", 512, 128),
            "elan_h3": Elan("elan_h3", 256, 128, 128, wide=True),
            "mp_h4": MP("mp_h4", 128, 128),
            "elan_h4b": Elan("elan_h4b", 512, 256, 256, wide=True),
            "mp_h5": MP("mp_h5", 256, 256),
            "elan_h5": Elan("elan_h5", 1024, 512, 512, wide=True),
            "rep3": _conv("rep3.fused", 128, 256, 3),
            "rep4": _conv("rep4.fused", 256, 512, 3),
            "rep5": _conv("rep5.fused", 512, 1024, 3),
        }
        self.b = b
        no = self.na * (5 + nc)
        # the head's outputs: N(0, 1/fan_in), kept in float by the control
        self.head = [Conv(f"detect.m.{i}", c, no, act=None, std_gain=1.0,
                          quant=False) for i, c in enumerate((256, 512, 1024))]

    def specs(self):
        for layer in self.b.values():
            yield from specs_of(*getattr(layer, "layers", [layer]))
        yield from specs_of(*self.head)

    def features(self, P, x, o):
        b = self.b
        y = b["down2"](P, b["stem2"](P, b["stem1"](P, b["stem0"](P, x, o), o), o), o)
        y = b["mp3"](P, b["elan2"](P, y, o), o)
        p3 = b["elan3"](P, y, o)
        p4 = b["elan4"](P, b["mp4"](P, p3, o), o)
        p5 = b["elan5"](P, b["mp5"](P, p4, o), o)
        spp = b["sppcspc"](P, p5, o)
        h4 = b["elan_h4"](P, torch.cat([b["route4"](P, p4, o),
                                        up2(b["lat4"](P, spp, o))], 1), o)
        h3 = b["elan_h3"](P, torch.cat([b["route3"](P, p3, o),
                                        up2(b["lat3"](P, h4, o))], 1), o)
        h4b = b["elan_h4b"](P, torch.cat([b["mp_h4"](P, h3, o), h4], 1), o)
        h5 = b["elan_h5"](P, torch.cat([b["mp_h5"](P, h4b, o), spp], 1), o)
        return (b["rep3"](P, h3, o), b["rep4"](P, h4b, o), b["rep5"](P, h5, o))

    def raws(self, P, x, o=None):
        """The head convs' raw outputs, one (B, na * (5 + nc), h, w) a level."""
        o = o or Opts()
        return [conv(P, f, o) for conv, f in zip(self.head,
                                                 self.features(P, x, o))]

    def decode(self, raws):
        boxes_all, scores_all = [], []
        for i, raw in enumerate(raws):
            n, _, h, w = raw.shape
            sig = torch.sigmoid(raw.float().reshape(n, self.na, 5 + self.nc, h, w)
                                .permute(0, 3, 4, 1, 2))
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=raw.device),
                torch.arange(w, dtype=torch.float32, device=raw.device),
                indexing="ij")
            grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
            anchor = torch.tensor(ANCHORS[i], dtype=torch.float32,
                                  device=raw.device)[None, None, None]
            xy = (sig[..., :2].float() * 2.0 - 0.5 + grid) * STRIDES[i]
            wh = (sig[..., 2:4].float() * 2.0) ** 2 * anchor
            boxes_all.append(torch.cat([xy - wh / 2, xy + wh / 2], -1)
                             .reshape(n, -1, 4))
            scores_all.append((sig[..., 4:5] * sig[..., 5:]).float().reshape(n, -1, self.nc))
        return {"boxes": torch.cat(boxes_all, 1), "scores": torch.cat(scores_all, 1)}

    def __call__(self, P, x, o=None):
        return self.decode(self.raws(P, x, o))
