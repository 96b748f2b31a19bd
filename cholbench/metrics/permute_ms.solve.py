"""permute_ms.solve: host ms of the port's ``solve.permute`` spans (a host
right-hand side permuted into the padded solve layout, and the solution
out of it; outside ``solve.levels``) per traced solve request."""
from cholbench import program_spans


def read(ctx):
    return program_spans.ms_per_request(ctx, "solve", "solve.permute")
