"""Build counters for the analysis/plan layers.

Every expensive symbolic-phase artifact — symbolic analysis, scatter plans,
level schedules, device index plans — bumps a named counter when it is
*built* (never when a cached copy is returned), so a caller that reuses a
cached SymbolicFactor can check that nothing was rebuilt.

Deliberately a process-global registry (not per-object): the point is to
catch rebuilds wherever they happen, including paths that accidentally drop
a cached SymbolicFactor and re-analyze from scratch.
"""
from __future__ import annotations

from collections import defaultdict

COUNTS: dict = defaultdict(int)

#: counter names bumped by the plan/analysis builders (one per artifact kind)
BUILD_KINDS = (
    "symbolic_analyze",   # repro_torch.core.symbolic.symbolic_analyze
    "scatter_plan",       # repro_torch.core.relind.build_scatter_plan
    "schedule",           # repro_torch.core.schedule.build_schedule
    "device_plan",        # repro_torch.core.device_store.build_device_plan
    "fill_plan",          # repro_torch.core.plan_cache.build_fill_plan
)


def bump(name: str) -> None:
    COUNTS[name] += 1


def snapshot() -> dict:
    """Copy of the current counters (for later ``delta``)."""
    return dict(COUNTS)


def delta(before: dict) -> dict:
    """Counters that changed since ``before`` (name -> increment)."""
    return {
        k: v - before.get(k, 0) for k, v in COUNTS.items() if v != before.get(k, 0)
    }
