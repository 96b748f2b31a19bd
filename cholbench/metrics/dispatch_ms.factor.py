"""dispatch_ms.factor: host ms of the port's ``factor.levels`` span less the
``stage.chunk`` spans inside it (the host's launch of every group dispatch)
per traced factorization.  None where the program opens no
``stage.chunk``."""
from cholbench import program_spans, readers


def read(ctx):
    levels = program_spans.spans_in(ctx, "factor", "factor.levels")
    chunks = program_spans.spans_in(ctx, "factor", "stage.chunk")
    n = readers.traced_count(ctx)
    if not levels or not chunks or not n:
        return None
    inner = sum(c.dur for c in chunks
                if any(lv.t0 <= (c.t0 + c.t1) / 2 <= lv.t1 for lv in levels))
    return (sum(lv.dur for lv in levels) - inner) / n / 1e3
