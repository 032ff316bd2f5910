"""OSNet (Zhou et al., "Omni-Scale Feature Learning for Person
Re-Identification"; torchreid ``osnet_x*``) in float32, on a checkpoint
with its BatchNorm statistics (eps 1e-5) folded into the convs: 7x7/2
stem, 3x3/2 max-pool, three stages of two OS blocks (four lite-conv
streams under one shared channel gate) with 1x1 + 2x2 average-pool
transitions, 1x1 conv, global mean, Linear + BatchNorm1d + ReLU, L2
norm. Crops come in BGR; the stem is the RGB checkpoint's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.nn import Opts, Spec, conv, fake_int8

WIDTHS = {"osnet_x1_0": 1.0, "osnet_x0_75": 0.75, "osnet_x0_5": 0.5,
          "osnet_x0_25": 0.25}
MEAN = (0.485, 0.456, 0.406)  # RGB
STD = (0.229, 0.224, 0.225)
BN = (("bn_scale", 1.0), ("bn_bias", 0.0), ("bn_mean", 0.0), ("bn_var", 1.0))


class Model:
    def __init__(self, variant: str = "osnet_x0_25", feat_dim: int = 512):
        m = WIDTHS[variant]
        self.c = tuple(int(c * m) for c in (64, 256, 384, 512))
        self.feat_dim = feat_dim
        self._specs: list[Spec] = []
        c1, c2, c3, c4 = self.c
        self._conv_bn("stem", 3, c1, 7)
        for name, a, b in (("b2a", c1, c2), ("b2b", c2, c2), ("b3a", c2, c3),
                           ("b3b", c3, c3), ("b4a", c3, c4), ("b4b", c4, c4)):
            self._block(name, a, b)
        self._conv_bn("t2", c2, c2, 1)
        self._conv_bn("t3", c3, c3, 1)
        self._conv_bn("conv5", c4, c4, 1)
        self._conv_bias("fc.lin", c4, feat_dim, 1, gain=1.0)
        self._specs += [Spec(f"fc.bn.{k}", (feat_dim,), fill=v) for k, v in BN]

    # -- weight specs, in the draws of torchreid's init as the program
    # -- makes them: He-normal under a BN, N(0, 1/fan_in) with a bias
    def _conv_bn(self, name, c_in, c_out, k, groups=1):
        std = math.sqrt(2.0 / (c_in // groups * k * k))
        self._specs.append(Spec(f"{name}.w", (c_out, c_in // groups, k, k), std=std))
        self._specs += [Spec(f"{name}.{key}", (c_out,), fill=v) for key, v in BN]

    def _conv_bias(self, name, c_in, c_out, k, gain):
        std = math.sqrt(gain / (c_in * k * k))
        self._specs += [Spec(f"{name}.w", (c_out, c_in, k, k), std=std),
                        Spec(f"{name}.b", (c_out,))]

    def _block(self, name, c_in, c_out):
        mid = c_out // 4
        self._conv_bn(f"{name}.conv1", c_in, mid, 1)
        r = max(mid // 16, 1)
        self._conv_bias(f"{name}.gate.fc1", mid, r, 1, gain=1.0)
        self._conv_bias(f"{name}.gate.fc2", r, mid, 1, gain=1.0)
        self._conv_bn(f"{name}.conv3", mid, c_out, 1)
        for t in range(4):
            for j in range(t + 1):
                self._conv_bias(f"{name}.streams.{t}.{j}.pw", mid, mid, 1, gain=2.0)
                self._conv_bn(f"{name}.streams.{t}.{j}.dw", mid, mid, 3, groups=mid)
        if c_in != c_out:
            self._conv_bn(f"{name}.down", c_in, c_out, 1)

    def specs(self):
        return iter(self._specs)

    # -- forward
    @staticmethod
    def _conv(P, name, x, o, *, stride=1, groups=1, bn=True, relu=True):
        """A conv with its BatchNorm (eps 1e-5) folded into its weight and
        bias in float32, as the served model holds them, then computed at
        the forward's precision."""
        w = P[name + ".w"].float()
        b = P[name + ".b"].float() if not bn else torch.zeros(w.shape[0], device=w.device)
        if bn:
            scale = P[name + ".bn_scale"] * torch.rsqrt(P[name + ".bn_var"] + 1e-5)
            w = w * scale[:, None, None, None]
            b = (b - P[name + ".bn_mean"]) * scale + P[name + ".bn_bias"]
        y = conv(x, w, b, stride, w.shape[-1] // 2, groups, o)
        if o.macs is not None:
            o.macs.append(y[0].numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return F.relu(y) if relu else y

    def _block_fwd(self, P, name, x, o):
        y = self._conv(P, f"{name}.conv1", x, o)
        agg = 0.0
        for t in range(4):
            s = y
            for j in range(t + 1):
                s = self._conv(P, f"{name}.streams.{t}.{j}.pw", s, o, bn=False,
                               relu=False)
                s = self._conv(P, f"{name}.streams.{t}.{j}.dw", s, o,
                               groups=s.shape[1])
            g = s.mean((2, 3), keepdim=True)
            g = self._conv(P, f"{name}.gate.fc1", g, o, bn=False)
            g = self._conv(P, f"{name}.gate.fc2", g, o, bn=False, relu=False)
            agg = agg + s * torch.sigmoid(g)
        res = (self._conv(P, f"{name}.down", x, o, relu=False)
               if f"{name}.down.w" in P else x)
        return F.relu(self._conv(P, f"{name}.conv3", agg, o, relu=False) + res)

    def __call__(self, P, crops: torch.Tensor, o: Opts | None = None) -> torch.Tensor:
        """(M, 3, 128, 64) BGR crops in [0, 1] -> (M, feat_dim) L2-normed."""
        o = o or Opts()
        dev = crops.device
        mean = torch.tensor(MEAN, device=dev).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=dev).view(1, 3, 1, 1)
        x = ((crops.float().flip(1) - mean) / std).to(o.dtype)
        x = F.max_pool2d(self._conv(P, "stem", x, o, stride=2), 3, 2, 1)
        x = self._block_fwd(P, "b2b", self._block_fwd(P, "b2a", x, o), o)
        x = F.avg_pool2d(self._conv(P, "t2", x, o), 2)
        x = self._block_fwd(P, "b3b", self._block_fwd(P, "b3a", x, o), o)
        x = F.avg_pool2d(self._conv(P, "t3", x, o), 2)
        x = self._block_fwd(P, "b4b", self._block_fwd(P, "b4a", x, o), o)
        x = self._conv(P, "conv5", x, o).mean((2, 3))
        scale = P["fc.bn.bn_scale"] * torch.rsqrt(P["fc.bn.bn_var"] + 1e-5)
        w = P["fc.lin.w"].flatten(1).float() * scale[:, None]
        b = (P["fc.lin.b"] - P["fc.bn.bn_mean"]) * scale + P["fc.bn.bn_bias"]
        if o.int8:
            y = F.linear(fake_int8(x.float()), fake_int8(w, per_channel=True), b)
        else:
            y = F.linear(x, w.to(o.dtype), b.to(o.dtype))
        y = F.relu(y).float()
        return y / torch.clamp(y.norm(dim=-1, keepdim=True), min=1e-12)
