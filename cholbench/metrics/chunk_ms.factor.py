"""chunk_ms.factor: host ms of the port's ``stage.chunk`` spans (a level's
value gather, its pinned copy and the start of its upload; level 0 inside
``factor.stage``, the others inside ``factor.levels``) per traced
factorization."""
from cholbench import readers


def read(ctx):
    return readers.range_ms(ctx, "factor", "stage.chunk")
