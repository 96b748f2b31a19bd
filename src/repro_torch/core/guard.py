"""Breakdown-safety primitives: guard reports, structured errors, input validation.

Port of ``src/repro/core/guard.py`` (pure numpy, copied so the port imports
nothing of the reference).  The guarded fused kernel
(``repro_torch.kernels.fused.fused_factor_syrk_guarded``: CUDA on the card,
its plain version on the CPU) emits a per-lane *status row* for every
supernode in a fused group dispatch:

    status[lane] = (min_d2, n_clamped, nonfinite, magnitude)

where ``min_d2`` is the minimum *squared* pivot value seen while eliminating
the lane's diagonal block (``inf`` for pad lanes), ``n_clamped`` counts pivots
boosted to the perturbation threshold, and ``nonfinite`` flags NaN/Inf
anywhere in the lane's live factor panel.  The lanes ride back to the host
inside the one existing per-factorization readback (zero extra transfers) and
are reduced into a :class:`GuardReport` (``numeric._reduce_guard``).

Policy lives in ``repro_torch.core.api.cholesky(guard=...)``:

    off      no detection: the unguarded kernel, bit-identical to pre-guard
    raise    detect; throw BreakdownError naming the first broken supernode
    perturb  clamp pivots below eps*4096*max|diag(A)| (or below the
             element-growth floor theta^2/max|diag|) during elimination,
             record the perturbations, refine solves back to full precision
    shift    retry with growing global diagonal shifts until clean
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = [
    "GuardReport",
    "BreakdownError",
    "BadMatrixError",
    "validate_matrix",
    "perturb_threshold",
]

#: detection-threshold multiplier: thr = EPS_MULT * eps * max|diag(A)|.
#: Pivots below thr are perturbed (CHOLMOD dbound style); boosting to a bare
#: eps-level thr is NOT safe on its own — a zero pivot under O(1)
#: off-diagonals (saddle-point constraint rows) boosted to thr amplifies its
#: column of L by 1/sqrt(thr) and the Schur cascade compounds geometrically.
#: The clamp therefore also enforces a GMW81-style element-growth floor,
#: theta^2 / max|diag| (theta = largest below-diagonal entry of the unscaled
#: column), which caps scaled-column entries at sqrt(max|diag|).  Because the
#: resulting LL^T factors A + E with E a nonnegative DIAGONAL modification of
#: rank n_clamped and bounded norm, GMRES refinement preconditioned by the
#: perturbed factor removes the perturbation in ~n_clamped iterations.
EPS_MULT = 4096.0

#: growth-floor multiplier: gfloor = theta^2 * GFLOOR_MULT / thr.  With
#: thr = EPS_MULT * eps * max|diag| this equals theta^2 / max|diag| exactly,
#: so the kernels recover the growth floor from thr alone (no extra scalar).
GFLOOR_MULT = float(np.finfo(np.float64).eps) * EPS_MULT


def perturb_threshold(max_abs_diag: float) -> float:
    """CHOLMOD-style dynamic perturbation threshold for a given diagonal
    scale.  Pivots with d^2 below this (or below the element-growth floor,
    see :data:`GFLOOR_MULT`) are boosted under ``guard="perturb"``."""
    eps = float(np.finfo(np.float64).eps)
    return eps * EPS_MULT * float(max_abs_diag)


@dataclass
class GuardReport:
    """Reduced per-factorization breakdown report.

    ``broken`` lists supernodes whose minimum pivot was nonpositive/nonfinite
    (or whose panel went nonfinite) when no clamping was active;
    ``perturbations`` lists supernodes whose pivots were boosted to the
    threshold under ``guard="perturb"``.  ``ir_history`` collects the
    residual trajectory of every refined solve run against this factor.
    """

    guard: str = "raise"
    n_supernodes: int = 0
    min_pivot: float = float("inf")
    level_min_pivots: List[Tuple[int, Optional[float]]] = field(default_factory=list)
    first_broken: Optional[int] = None
    first_broken_level: Optional[int] = None
    broken: List[Dict[str, Any]] = field(default_factory=list)
    perturbations: List[Dict[str, Any]] = field(default_factory=list)
    perturb_thr: float = 0.0
    shift: float = 0.0
    shifts: int = 0
    downgrades: int = 0
    ir_history: List[List[float]] = field(default_factory=list)
    validation: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        """True when the factor is clean (possibly after recorded recovery)."""
        return not self.broken

    @property
    def n_perturbed(self) -> int:
        return int(sum(p["n_clamped"] for p in self.perturbations))

    @property
    def needs_refine(self) -> bool:
        """True when solves against this factor should run iterative refinement."""
        return bool(self.perturbations) or self.shift > 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "guard": self.guard,
            "ok": self.ok,
            "n_perturbed": self.n_perturbed,
            "n_supernodes": self.n_supernodes,
            "min_pivot": _jsonf(self.min_pivot),
            "level_min_pivots": [[l, _jsonf(v)] for l, v in self.level_min_pivots],
            "first_broken": self.first_broken,
            "first_broken_level": self.first_broken_level,
            "broken": [dict(b, min_pivot=_jsonf(b["min_pivot"])) for b in self.broken],
            "perturbations": [
                dict(p, min_pivot=_jsonf(p["min_pivot"])) for p in self.perturbations
            ],
            "perturb_thr": self.perturb_thr,
            "shift": self.shift,
            "shifts": self.shifts,
            "downgrades": self.downgrades,
            "ir_history": self.ir_history,
            "validation": self.validation,
        }


def _jsonf(v):
    """JSON-safe float: inf/nan become None."""
    if v is None:
        return None
    v = float(v)
    return v if np.isfinite(v) else None


class BreakdownError(RuntimeError):
    """Factorization broke down (non-positive-definite pivot or nonfinite panel).

    Carries the :class:`GuardReport` describing where, so callers (and the
    serving layer) can turn the failure into a structured result.
    """

    def __init__(self, report: GuardReport, message: Optional[str] = None):
        self.report = report
        if message is None:
            if report.first_broken is not None:
                mp = (report.broken[0]["min_pivot"] if report.broken
                      else report.min_pivot)
                message = (
                    f"Cholesky breakdown at supernode {report.first_broken} "
                    f"(level {report.first_broken_level}): min pivot d^2 = "
                    f"{mp:.6g}"
                )
            else:
                message = "Cholesky breakdown (no supernode identified)"
        super().__init__(message)


class BadMatrixError(ValueError):
    """Input matrix rejected before factorization (nonfinite or non-symmetric)."""

    def __init__(self, kind: str, message: str, validation: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.validation = validation
        super().__init__(f"bad matrix ({kind}): {message}")


def validate_matrix(A, *, asym_tol: float = 1e-10) -> Dict[str, Any]:
    """Sanity-check a matrix before guarded factorization.

    Returns ``{"n", "nnz", "max_abs", "asymmetry", "max_abs_diag"}``; raises
    :class:`BadMatrixError` on NaN/Inf entries or relative asymmetry beyond
    ``asym_tol``.
    """
    A = sp.csc_matrix(A)
    n = int(A.shape[0])
    data = np.asarray(A.data, dtype=np.float64)
    finite = np.isfinite(data)
    max_abs = float(np.max(np.abs(data[finite]))) if np.any(finite) else 0.0
    info = {"n": n, "nnz": int(A.nnz), "max_abs": max_abs, "asymmetry": 0.0}
    if not np.all(finite):
        nbad = int(np.count_nonzero(~finite))
        raise BadMatrixError("nonfinite", f"{nbad} nonfinite entries", info)
    asym = float(np.max(np.abs((A - A.T).data))) if (A - A.T).nnz else 0.0
    info["asymmetry"] = asym
    if asym > asym_tol * max(max_abs, 1.0):
        raise BadMatrixError(
            "asymmetric",
            f"max |A - A^T| = {asym:.3g} exceeds {asym_tol:g} * max|A| = "
            f"{asym_tol * max(max_abs, 1.0):.3g}",
            info,
        )
    d = A.diagonal()
    info["max_abs_diag"] = float(np.max(np.abs(d))) if n else 0.0
    return info
