"""solve_bw_share.solve: a request's least bytes (the factor and the
right-hand sides read once, the solutions written once; ``work.py``) at
the HBM peak over the mean seconds per request of the untraced
requests, %."""
from cholbench import readers, work


def read(ctx):
    s = readers.mean_request_s(ctx, "solve")
    if not s:
        return None
    w, r = ctx.shapes()
    b = work.solve_bytes(w, r, ctx.work["n"], ctx.work["nrhs"])
    return 100.0 * b / ctx.peaks["hbm_bytes_per_s"] / s
