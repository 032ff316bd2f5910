"""Host ms a tick blocked on the ReID detection counts
(``Pipeline.count_wait_ms / count_waits``, the program's counter) over
the window."""


def read(ctx):
    n = ctx.host["count_waits"]
    return ctx.host["count_wait_ms"] / n if n else None
