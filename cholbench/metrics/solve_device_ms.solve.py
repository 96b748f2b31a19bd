"""solve_device_ms.solve: device ms (the union of their intervals) of the
kernels and copies issued inside ``solve.levels``, per traced request."""
from cholbench import readers


def read(ctx):
    return readers.device_ms_in(ctx, "solve", "solve.levels")
