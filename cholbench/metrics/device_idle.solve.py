"""device_idle.solve: the share of a solve request in which no kernel, copy
or memset ran on the device: one less the union of their intervals over
the traced requests, per solve, over the client's mean time of an
untraced request, %."""
from cholbench import readers


def read(ctx):
    return readers.idle_pct(ctx, "solve")
