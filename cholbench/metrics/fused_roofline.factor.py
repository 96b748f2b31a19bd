"""fused_roofline.factor: the least time of a factorization's fused-kernel
work, the larger of its flops at the fp64 tensor peak and its lane bytes
at the HBM peak (``work.py``, from the unpadded supernode shapes), over
the device time of every launch of the fused kernel's functions per
traced factorization, %."""
from cholbench import readers, work
from cholbench.trace import function_name

#: the __global__ functions of the port's fused_factor_syrk.cu
FUNCS = {"mask_kernel", "panel_kernel", "trailing_kernel", "syrk_kernel",
         "guard_init_kernel", "guarded_slab_kernel"}


def read(ctx):
    reqs = readers.traced_requests(ctx, "factor")
    n = readers.traced_count(ctx)
    if not reqs or not n:
        return None
    lo, hi = reqs[0].t0, reqs[-1].t1
    us = sum(op.dur for op in ctx.trace.device
             if lo <= op.t0 <= hi
             and function_name(op.name) in FUNCS)
    if us <= 0:
        return None
    w, r = ctx.shapes()
    least = max(work.factor_flops(w, r) / ctx.peaks["fp64_tensor_flops"],
                work.fused_bytes(w, r) / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (us / 1e6 / n)
