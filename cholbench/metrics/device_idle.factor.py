"""device_idle.factor: the share of a factor request in which no kernel, copy
or memset ran on the device: one less the union of their intervals over
the traced requests, per factorization, over the client's mean time of an
untraced request, %."""
from cholbench import readers


def read(ctx):
    return readers.idle_pct(ctx, "factor")
