"""solve_s: the window's seconds over the solve requests completed in it."""


def read(ctx):
    if ctx.win.kind != "solve":
        return None
    done = sum(1 for *_, ok in ctx.win.reqs if ok)
    return ctx.win.seconds / done if done else None
