"""fill_ms.factor: host ms of the port's ``factor.fill`` range per
traced factorization."""
from cholbench import readers


def read(ctx):
    return readers.range_ms(ctx, "factor", "factor.fill")
