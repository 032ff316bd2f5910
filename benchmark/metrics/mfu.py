"""The whole step's share of the card's bf16 peak (989 TFLOP/s, dense):
the detector's operations a frame (two per multiply-add of every conv at
the configuration's input size, counted on the reference model's layer
shapes) times the stream-frames completed in the window, over the
window's seconds."""

import torch

from reference.nn import Opts


def detector_ops(model, imgsz: int) -> float:
    macs = []
    P = {sp.key: torch.empty(sp.shape, device="meta") for sp in model.specs()}
    x = torch.empty((1, 3, imgsz, imgsz), device="meta")
    model(P, x, Opts(macs=macs))
    return 2.0 * sum(macs)


def read(ctx):
    done = ctx.streams * ctx.window.completed
    if done == 0:
        return None
    ops = detector_ops(ctx.det_model, ctx.cfg["detector"]["imgsz"])
    return 100.0 * done * ops / ctx.window_s / ctx.roofline.PEAK_OPS_PER_S["bf16"]
