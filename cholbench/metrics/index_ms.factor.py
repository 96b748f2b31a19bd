"""index_ms.factor: host ms of the port's ``stage.index`` span (inside
``factor.stage``: the index plan's concatenation, its one upload and
widening, the per-group views and casts) per traced factorization."""
from cholbench import readers


def read(ctx):
    return readers.range_ms(ctx, "factor", "stage.index")
