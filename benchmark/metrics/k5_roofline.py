"""K5's share of its roofline: the operations of the pyramidal LK over
the S frame pairs (``roofline.k5_work``, about 90 float32 operations a
pixel and Gauss-Newton step) over its mean kernel time in the trace."""

from metrics._ticks import kernel

KERNELS = ("lk_pyramid_kernel",)


def read(ctx):
    secs, n = kernel(ctx, *KERNELS)
    if n == 0:
        return None
    r = ctx.roofline
    nbytes, ops = r.k5_work(ctx.streams)
    return 100.0 * r.bound_s(nbytes, ops, "f32") / (secs / n)
