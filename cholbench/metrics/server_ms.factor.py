"""server_ms.factor: a traced factor request's time less the port's
``factor.*`` ranges inside it (plan lookup and fingerprint, validation,
the server's bookkeeping), ms a request; the profiler's own host cost
outside those ranges is in it."""
from cholbench import readers


def read(ctx):
    return readers.server_ms(ctx, "factor", readers.FACTOR_RANGES)
