"""readback_copy_ms.factor: host ms of the port's ``read_back.copy`` span
(inside ``factor.read_back``: the packed factor's concatenation and its
device-to-host copy, which waits for the levels' device work) per traced
factorization."""
from cholbench import readers


def read(ctx):
    return readers.range_ms(ctx, "factor", "read_back.copy")
