"""K1's share of its roofline: the least time its bytes take
(``roofline.k1_bytes``: the weighed sectors of the S 1080p frames, the
tap tables and the bf16 output) over its mean kernel time in the trace."""

from metrics._ticks import kernel

KERNELS = ("letterbox_kernel",)


def read(ctx):
    secs, n = kernel(ctx, *KERNELS)
    if n == 0:
        return None
    r = ctx.roofline
    h, w = ctx.frame_hw
    size = ctx.cfg["detector"]["imgsz"]
    out_bytes = 2 if ctx.cfg["detector"]["dtype"] == "bfloat16" else 4
    bound = r.bound_s(r.k1_bytes(ctx.streams, h, w, size, out_bytes), 0.0)
    return 100.0 * bound / (secs / n)
