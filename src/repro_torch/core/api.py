"""Public API of the port:

    from repro_torch.core import cholesky
    F = cholesky(A)                       # on the card; device="cpu" on the host
    x = F.solve(b, backend="device")

``cholesky`` routes as the reference's ``cholesky`` does, with a device
engine always present (the port's entry points run on the card unless asked
for the CPU):

    schedule='levels' (default)  ``factorize_levels``: fully device-resident
                                 at a zero offload threshold (the main path),
                                 host assembly with device batches above it
                                 or with ``assembly='host'``
    schedule='seq'               the paper's one-supernode-at-a-time loops,
                                 ``factorize_rl`` / ``factorize_rlb``, with
                                 supernodes of rows*w >= offload_threshold
                                 on the device and the rest in numpy

The breakdown guard and the plan cache raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core.engines import DeviceEngine
from repro_torch.core.merge import merge_supernodes
from repro_torch.core.numeric import (
    CholeskyFactor,
    HostEngine,
    OffloadPolicy,
    factorize_levels,
    factorize_rl,
    factorize_rlb,
)
from repro_torch.core.refine import refine_partition
from repro_torch.core.symbolic import SymbolicFactor, symbolic_analyze
from repro_torch.sparse.ordering import fill_reducing_ordering


def symbolic_pipeline(
    A: sp.spmatrix,
    *,
    ordering: str = "nd",
    merge: bool = True,
    refine: bool = True,
    max_growth: float = 0.25,
) -> tuple[SymbolicFactor, sp.csc_matrix]:
    """The paper's preprocessing pipeline: fill-reducing ordering ->
    symbolic factorization -> supernode amalgamation (25% storage cap) ->
    partition refinement.  Returns (sym, permuted matrix)."""
    A = sp.csc_matrix(A)
    order = fill_reducing_ordering(A, ordering)
    sym, Aperm = symbolic_analyze(A, order=order)
    if merge:
        sym = merge_supernodes(sym, max_growth=max_growth)
    if refine:
        sym, g = refine_partition(sym)
        Aperm = Aperm[g][:, g].tocsc()
        Aperm.sort_indices()
    return sym, Aperm


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def cholesky(
    A: sp.spmatrix,
    *,
    method: str = "rl",
    ordering: str = "nd",
    merge: bool = True,
    refine: bool = True,
    max_growth: float = 0.25,
    device=None,
    device_engine: DeviceEngine | None = None,
    offload_threshold: int | None = None,
    batch_transfers: bool = False,
    schedule: str | None = None,
    max_batch: int = 256,
    assembly: str = "auto",
    staging: str | None = None,
    sym: SymbolicFactor | None = None,
    Aperm: sp.csc_matrix | None = None,
    plan=None,
    guard: str = "off",
) -> CholeskyFactor:
    """Factor a sparse SPD matrix.

    method             'rl' or 'rlb' (the sequential schedule's variant; the
                       levels schedule always runs the RL formulation)
    device             'cuda' (default; raises without a card) or 'cpu' (the
                       kernels' plain PyTorch versions); sets the engine when
                       ``device_engine`` is not given
    device_engine      a DeviceEngine to run on (its stats and events record
                       the run); ``DeviceEngine(fused=False)`` makes the
                       sequential path call potrf, trsm_rlt and syrk_ln
                       instead of the fused kernel
    offload_threshold  supernodes with rows*w >= this run on the device, the
                       rest in numpy (None or 0: all on the device); the
                       paper uses 600,000 for RL and 750,000 for RLB
    batch_transfers    RLB on 'seq' only: keep a supernode's block updates on
                       the device and read them back in one transfer
    schedule           'levels' (default) or 'seq'
    assembly           levels only: 'auto', 'host' or 'device' (see
                       ``factorize_levels``)
    staging            device-resident levels path only: 'async' (default)
                       or 'sync'
    sym / Aperm        reuse a symbolic factorization; ``sym`` alone is
                       enough, the permuted matrix is rebuilt from ``sym.perm``

    The other arguments mirror the reference's ``cholesky``; ``guard`` other
    than 'off' and ``plan`` raise NotImplementedError.
    """
    if method not in ("rl", "rlb"):
        raise ValueError(f"unknown method {method!r} (want 'rl' or 'rlb')")
    if schedule is None:
        schedule = "levels"
    if schedule not in ("seq", "levels"):
        raise ValueError(f"unknown schedule {schedule!r} (want 'seq' or 'levels')")
    if assembly not in ("auto", "host", "device"):
        raise ValueError(
            f"unknown assembly {assembly!r} (want 'auto', 'host', or 'device')"
        )
    if assembly != "auto" and schedule == "seq":
        raise ValueError(
            f"assembly={assembly!r} only applies to schedule='levels' "
            "(the sequential paths always assemble on the host)"
        )
    if batch_transfers and schedule == "levels":
        raise ValueError(
            "batch_transfers applies only to the sequential RLB path; "
            "pass schedule='seq'"
        )
    if staging is not None and schedule != "levels":
        raise ValueError(
            "staging applies only to the device-resident levels schedule"
        )
    if guard not in ("off", "raise", "perturb", "shift"):
        raise ValueError(
            f"unknown guard {guard!r} (want 'off', 'raise', 'perturb', or "
            "'shift')"
        )
    if guard != "off":
        raise _not_ported(f"guard={guard!r}", "6")
    if plan is not None:
        raise _not_ported("plan= (the plan cache)", "7")
    if device_engine is None:
        device_engine = DeviceEngine(device=device)
    elif device is not None and device_engine.device.type != \
            torch.device(device).type:
        raise ValueError(
            f"device={device!r} disagrees with the engine's device "
            f"{device_engine.device}"
        )
    policy = OffloadPolicy(threshold=offload_threshold or 0)
    if sym is None:
        sym, Aperm = symbolic_pipeline(
            A, ordering=ordering, merge=merge, refine=refine,
            max_growth=max_growth,
        )
    elif Aperm is None:
        # sym.perm already folds in any refinement reordering
        p = sym.perm
        Aperm = sp.csc_matrix(A)[p][:, p].tocsc()
        Aperm.sort_indices()
    if schedule == "levels":
        return factorize_levels(
            sym, Aperm, engine=HostEngine(), device_engine=device_engine,
            policy=policy, max_batch=max_batch, assembly=assembly,
            staging=staging,
        )
    if method == "rl":
        return factorize_rl(sym, Aperm, engine=HostEngine(),
                            device_engine=device_engine, policy=policy)
    return factorize_rlb(sym, Aperm, engine=HostEngine(),
                         device_engine=device_engine, policy=policy,
                         batch_transfers=batch_transfers)


def solve(A: sp.spmatrix, b: np.ndarray, *, solve_backend: str = "host",
          **kw) -> np.ndarray:
    """Factor-and-solve convenience wrapper.  ``solve_backend`` picks the
    substitution path ('host' loop or 'device' level-scheduled batched —
    see CholeskyFactor.solve); every other keyword goes to ``cholesky``."""
    return cholesky(A, **kw).solve(b, backend=solve_backend)
