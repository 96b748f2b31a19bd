"""solve_p95_s: the 95th percentile of the client's latency over every
solve request of the window (numpy's linear interpolation)."""
import numpy as np


def read(ctx):
    if ctx.win.kind != "solve" or not ctx.win.reqs:
        return None
    return float(np.percentile([t1 - t0 for t0, t1, _, _ in ctx.win.reqs],
                               95))
