"""Helpers the readers share."""


def traced_ticks(ctx) -> int:
    """Ticks whose device work the trace holds: K1 runs once a tick."""
    if ctx.trace is None:
        return 0
    return sum(c for name, (_, c) in ctx.trace["kernels"].items()
               if "letterbox_kernel" in name)


def kernel(ctx, *needles) -> tuple[float, int]:
    """Seconds and launches of the traced kernels whose name holds a needle."""
    if ctx.trace is None:
        return 0.0, 0
    secs, count = 0.0, 0
    for name, (s, c) in ctx.trace["kernels"].items():
        if any(n in name for n in needles):
            secs += s
            count += c
    return secs, count
