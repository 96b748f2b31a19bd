"""index_bytes_mb.factor: host-to-device MB of index arrays per
factorization of the window, the growth of
``DeviceEngine.stats["index_bytes_in"]`` (a count that repeats exactly);
``bytes_in_mb.factor`` less it is the values' MB.  None where the engine
keeps no such count."""


def read(ctx):
    c = ctx.win.counters
    if (ctx.win.kind != "factor" or not ctx.win.completed()
            or "index_bytes_in" not in c):
        return None
    return c["index_bytes_in"] / ctx.win.completed() / 1e6
