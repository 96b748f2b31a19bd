"""The port's named spans: ``torch.profiler`` ranges that cost one flag
check when no profiler runs.

    with span("factor.stage"):
        ...

Under a profiler a span is ``torch.profiler.record_function(name)``, so it
shares the device trace's clock and nests in the trace as the code nests.
Otherwise it is one shared ``contextlib.nullcontext()``: a
``record_function`` with no profiler still costs several microseconds a
range on the host, which the served path would pay in every request.

A span's name carries no request id (the Chrome export drops a range's
``args``): a request is the ``serve.<kind>`` span that encloses it on its
thread.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else the
    shared null context."""
    return record_function(name) if _enabled() else _NULL
