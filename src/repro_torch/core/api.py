"""Public API of the port:

    from repro_torch.core import cholesky
    F = cholesky(A)                       # on the card; device="cpu" on the host
    x = F.solve(b, backend="device")

``cholesky`` runs the main path of the reference's
``cholesky(A, device_engine=DeviceEngine(backend="pallas"))``: the fully
offloaded, device-resident, level-scheduled factorization.  The reference's
other routes raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

import scipy.sparse as sp
import torch

from repro_torch.core.engines import DeviceEngine
from repro_torch.core.merge import merge_supernodes
from repro_torch.core.numeric import CholeskyFactor, _factorize_levels_device
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
    schedule: str | None = None,
    max_batch: int = 256,
    staging: str | None = None,
    sym: SymbolicFactor | None = None,
    Aperm: sp.csc_matrix | None = None,
    plan=None,
    guard: str = "off",
) -> CholeskyFactor:
    """Factor a sparse SPD matrix on the device-resident levels path.

    device         'cuda' (default; raises without a card) or 'cpu' (the
                   kernels' plain PyTorch versions); sets the engine when
                   ``device_engine`` is not given
    device_engine  a DeviceEngine to run on (its stats and events record the
                   run)
    staging        'async' (default: per-level chunk uploads overlapping
                   compute) or 'sync' (one up-front upload)
    sym / Aperm    reuse a symbolic factorization; ``sym`` alone is enough,
                   the permuted matrix is rebuilt from ``sym.perm``

    The other arguments mirror the reference's ``cholesky``; the routes this
    port does not have yet (``method='rlb'``, ``schedule='seq'``, a guard, a
    plan, a mixed offload threshold) raise NotImplementedError.
    """
    if method not in ("rl", "rlb"):
        raise ValueError(f"unknown method {method!r} (want 'rl' or 'rlb')")
    if schedule not in (None, "seq", "levels"):
        raise ValueError(f"unknown schedule {schedule!r} (want 'seq' or 'levels')")
    if guard not in ("off", "raise", "perturb", "shift"):
        raise ValueError(
            f"unknown guard {guard!r} (want 'off', 'raise', 'perturb', or "
            "'shift')"
        )
    if schedule == "seq" or method == "rlb":
        raise _not_ported("schedule='seq' and method='rlb' (the sequential "
                          "RL/RLB paths)", "8")
    if guard != "off":
        raise _not_ported(f"guard={guard!r}", "6")
    if plan is not None:
        raise _not_ported("plan= (the plan cache)", "7")
    if offload_threshold not in (None, 0):
        raise _not_ported("mixed host/device offload", "8")
    if device_engine is None:
        device_engine = DeviceEngine(device=device)
    elif device is not None and device_engine.device.type != \
            torch.device(device).type:
        raise ValueError(
            f"device={device!r} disagrees with the engine's device "
            f"{device_engine.device}"
        )
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
    return _factorize_levels_device(sym, Aperm, device_engine,
                                    max_batch=max_batch, staging=staging)
