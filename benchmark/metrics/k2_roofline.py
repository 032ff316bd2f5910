"""K2's share of its roofline: the operations and bytes of the keep mask
over the (S, 512) score-sorted candidates (``roofline.k2_work``, float32)
over its mean kernel time in the trace."""

from metrics._ticks import kernel

KERNELS = ("nms_keep_kernel",)


def read(ctx):
    secs, n = kernel(ctx, *KERNELS)
    if n == 0:
        return None
    r = ctx.roofline
    nbytes, ops = r.k2_work(ctx.streams, 512)
    return 100.0 * r.bound_s(nbytes, ops, "f32") / (secs / n)
