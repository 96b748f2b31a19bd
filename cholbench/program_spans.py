"""What the readers of the port's own spans share beyond ``readers``: the
spans that ``repro_torch.core.spans.span`` opens inside the traced
requests' harness ranges (``cholbench.<label>``), and their host ms a
request.  Where the program opens no span of the names asked for, a reader
reports nothing."""
from __future__ import annotations

from cholbench import readers


def spans_in(ctx, label: str, *names: str) -> list:
    """The program's spans called one of ``names`` inside the traced
    requests."""
    reqs = readers.traced_requests(ctx, label)
    return [r for q in reqs for name in names
            for r in ctx.trace.named(name, q.t0, q.t1)]


def ms_per_request(ctx, label: str, *names: str):
    """Host ms of the spans ``names`` per traced request."""
    spans = spans_in(ctx, label, *names)
    if not spans:
        return None
    return sum(r.dur for r in spans) / len(
        readers.traced_requests(ctx, label)) / 1e3

