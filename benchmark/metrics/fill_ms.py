"""Host ms of the frame ring's fill of its pinned slot
(``utils/transfer.FrameRing.fill_ms``), mean a tick over the window."""

import numpy as np


def read(ctx):
    return float(np.mean(ctx.window.fill_ms)) if ctx.window.fill_ms else None
