"""substitute_ms.solve: host ms of the port's ``solve.substitute`` span
(inside ``solve.levels``: the host's launches of every forward and backward
substitution level) per traced solve request."""
from cholbench import program_spans


def read(ctx):
    return program_spans.ms_per_request(ctx, "solve", "solve.substitute")
