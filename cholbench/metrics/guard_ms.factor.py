"""guard_ms.factor: host ms of the port's ``guard.validate`` (input
validation) and ``guard.report`` (the guard report's reduction and
attachment) spans per traced factorization; None where no guard runs."""
from cholbench import readers


def read(ctx):
    ms = [readers.range_ms(ctx, "factor", name)
          for name in ("guard.validate", "guard.report")]
    ms = [v for v in ms if v is not None]
    return sum(ms) if ms else None
