"""bytes_in_mb.factor: host-to-device MB per factorization of the window,
the growth of ``DeviceEngine.stats["bytes_in"]`` (a count that repeats
exactly)."""


def read(ctx):
    if ctx.win.kind != "factor" or not ctx.win.completed():
        return None
    return ctx.win.counters.get("bytes_in", 0) / ctx.win.completed() / 1e6
