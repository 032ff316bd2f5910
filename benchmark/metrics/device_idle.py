"""Share of the traced slice in which no kernel or copy ran on the card
(the union of the device spans, all streams together)."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
