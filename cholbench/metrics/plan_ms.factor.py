"""plan_ms.factor: host ms of the port's ``serve.plan`` span (the pattern's
fingerprint, the plan cache lookup and the zero-rebuild check) per traced
factor request."""
from cholbench import program_spans


def read(ctx):
    return program_spans.ms_per_request(ctx, "factor", "serve.plan")
