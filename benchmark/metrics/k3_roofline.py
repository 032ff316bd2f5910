"""K3's share of its roofline a tick: every launch an (S, slots,
tracker_max_dets) auction, its bytes by ``roofline.k3_bytes`` (each cost
read once), over the kernel time a tick in the trace."""

from metrics._ticks import kernel, traced_ticks

KERNELS = ("auction_kernel",)


def read(ctx):
    secs, n = kernel(ctx, *KERNELS)
    ticks = traced_ticks(ctx)
    if n == 0 or ticks == 0:
        return None
    r = ctx.roofline
    nbytes = n * r.k3_bytes(ctx.streams, ctx.cfg["track_slots"],
                            ctx.cfg["tracker_max_dets"])
    return 100.0 * r.bound_s(nbytes, 0.0) / secs
