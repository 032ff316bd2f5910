"""Device ms a tick of the embed layer's own kernels: K4's crops and
K6's OSNet stages (the stem, pooling and head run as library kernels
that the trace cannot tell from the detector's)."""

from metrics._ticks import kernel, traced_ticks

KERNELS = ("banded_crop_kernel", "os_stage")


def read(ctx):
    secs, n = kernel(ctx, *KERNELS)
    ticks = traced_ticks(ctx)
    if n == 0 or ticks == 0:
        return None
    return 1e3 * secs / ticks
