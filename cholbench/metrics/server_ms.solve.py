"""server_ms.solve: a traced solve request's time less the port's
``solve.*`` ranges inside it, ms a request; the profiler's own host
cost outside those ranges is in it."""
from cholbench import readers


def read(ctx):
    return readers.server_ms(ctx, "solve", readers.SOLVE_RANGES)
