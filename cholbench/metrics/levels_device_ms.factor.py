"""levels_device_ms.factor: device ms (the union of their intervals) of
the kernels and copies issued inside ``factor.levels``, per traced
factorization."""
from cholbench import readers


def read(ctx):
    return readers.device_ms_in(ctx, "factor", "factor.levels")
