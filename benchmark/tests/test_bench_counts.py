"""The roofline arithmetic against counts by hand."""

import torch

from harness import roofline
from metrics.mfu import detector_ops
from reference.nn import Conv, Opts, Spec


class OneConv:
    def __init__(self):
        self.conv = Conv("c", 3, 32, 3, 2)

    def specs(self):
        return self.conv.specs()

    def __call__(self, P, x, o):
        return self.conv(P, x, o)


def test_one_conv_ops():
    # 3 -> 32, 3x3 stride 2 at 64 x 64: 32 x 32 outputs of 32 channels,
    # 27 multiply-adds each, two operations a multiply-add
    assert detector_ops(OneConv(), 64) == 2 * 32 * 32 * 32 * 27


def test_int8_round_trip_and_macs_on_a_real_conv():
    conv = Conv("c", 4, 8, 1)
    P = {"c.w": torch.randn(8, 4, 1, 1), "c.b": torch.zeros(8)}
    x = torch.randn(1, 4, 5, 5)
    macs = []
    y = conv(P, x, Opts(int8=True, macs=macs))
    assert macs == [5 * 5 * 8 * 4] and y.shape == (1, 8, 5, 5)
    assert not torch.equal(y, conv(P, x, Opts()))


def test_k1_bytes_by_hand():
    # 1080 x 1920 -> 360 x 640 samples rows 3i + 1 and columns 3j + 1;
    # a row's samples lie 9 bytes apart, so each sampled row moves all
    # 180 of its 32-byte sectors
    s = 2
    frame = s * 360 * 1920 * 3
    taps = 2 * 2 * (360 + 640) * 4
    out = s * 3 * 640 * 640 * 2
    assert roofline.k1_bytes(s, 1080, 1920, 640, 2) == frame + taps + out


def test_one_lk_level_by_hand():
    # one pair: the three float32 levels of both frames read once, 6
    # params in and out; 90 operations a pixel and step over 180 x 320 x
    # 2 + 90 x 160 x 5 + 45 x 80 x 8 pixel-steps
    nbytes, ops = roofline.k5_work(1)
    assert nbytes == 2 * (180 * 320 + 90 * 160 + 45 * 80) * 4 + 2 * 6 * 4
    assert ops == 90 * (180 * 320 * 2 + 90 * 160 * 5 + 45 * 80 * 8)


def test_k2_k3_and_bound():
    nbytes, ops = roofline.k2_work(1, 4)
    assert nbytes == 4 * 21 and ops == 15 * 6
    assert roofline.k3_bytes(1, 2, 3) == 2 * 3 * 4 + 5 + 4 + 5 * 4
    assert roofline.bound_s(3.35e12, 0.0) == 1.0
    assert roofline.bound_s(0.0, 67e12, "f32") == 1.0


def test_weight_specs_are_drawn_or_filled():
    from harness import weights

    g = weights.generator(5, "cpu", 1)
    P = weights.make([Spec("a", (2, 3), std=2.0), Spec("b", (4,), fill=1.0)], g, "cpu")
    assert P["b"].tolist() == [1.0] * 4 and P["a"].shape == (2, 3)
    again = weights.make([Spec("a", (2, 3), std=2.0), Spec("b", (4,), fill=1.0)],
                         weights.generator(5, "cpu", 1), "cpu")
    assert torch.equal(P["a"], again["a"])
