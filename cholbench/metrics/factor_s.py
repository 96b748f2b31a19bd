"""factor_s: the window's seconds over the factorizations completed in it
(a request of M matrices counts M)."""


def read(ctx):
    if ctx.win.kind != "factor" or not ctx.win.completed():
        return None
    return ctx.win.seconds / ctx.win.completed()
