"""readback_scatter_ms.factor: host ms of the port's ``read_back.scatter``
span (inside ``factor.read_back``: the host scatter of the packed factor
into storage order) per traced factorization."""
from cholbench import readers


def read(ctx):
    return readers.range_ms(ctx, "factor", "read_back.scatter")
