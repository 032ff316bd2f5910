"""Host ms of ``BatchedPipeline.step_async`` a tick, mean over the window
(harness host clock): the host I/O layer's dispatch."""

import numpy as np


def read(ctx):
    return float(np.mean(ctx.window.dispatch_ms)) if ctx.window.dispatch_ms else None
