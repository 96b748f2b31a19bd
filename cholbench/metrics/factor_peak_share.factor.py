"""factor_peak_share.factor: a factorization's flops (``work.py``) over
the mean seconds per factorization of the untraced requests times the
fp64 tensor peak, %."""
from cholbench import readers, work


def read(ctx):
    s = readers.mean_request_s(ctx, "factor")
    if not s:
        return None
    w, r = ctx.shapes()
    return 100.0 * work.factor_flops(w, r) / (
        s * ctx.peaks["fp64_tensor_flops"])
