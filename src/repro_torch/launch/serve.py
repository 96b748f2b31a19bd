"""Solver-as-a-service driver: a long-lived factorization/solve server
(port of ``src/repro/launch/serve.py``).

Production solver workloads (Newton/interior-point outer loops, per-user
graph Laplacians over a fixed topology, batched covariance solves) are
request STREAMS dominated by repeated sparsity patterns.  ``CholeskyServer``
keeps the whole serving state resident across requests:

  * a pattern-keyed PlanCache (repro_torch.core.plan_cache) — a repeat
    pattern performs ZERO symbolic/schedule/plan rebuilds (enforced against
    repro_torch.core.counters on every repeat request);
  * one DeviceEngine whose fallback counters and event log persist across
    requests (the log is reset per factorization and ring-buffered);
  * device-resident factors — ``solve`` requests run level-scheduled batched
    substitution against the still-resident factor, and same-pattern matrix
    batches factor through ONE set of ``cholesky_many`` dispatches.

The CLI drives a synthetic request stream mixing new-pattern, repeat-pattern
(single and batched), and solve-only requests, and reports factorizations/sec
and solves/sec:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \
        --patterns 3 --grid 14 --many 4

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import scipy.sparse as sp

from repro_torch.core import cholesky, cholesky_many, counters
from repro_torch.core.engines import DeviceEngine
from repro_torch.core.guard import BadMatrixError, BreakdownError
from repro_torch.core.plan_cache import PlanCache

#: a refined solve that cannot push the relative residual below this is
#: served (best effort) but marks its factor dirty — the factor is evicted
#: so later requests re-factor instead of degrading silently forever
DIRTY_RESID = 1e-6


@dataclasses.dataclass
class ServeStats:
    """Cumulative request accounting (cache stats live on the PlanCache)."""
    factorizations: int = 0      # matrices factored (a batch of M counts M)
    factor_requests: int = 0     # factor/factor_many requests served
    solves: int = 0              # RHS columns solved
    solve_requests: int = 0
    factor_s: float = 0.0        # wall time inside factor requests
    solve_s: float = 0.0         # wall time inside solve requests
    repeat_rebuilds: int = 0     # analysis builds triggered by repeat-pattern
    #                              requests — the zero-rebuild guarantee says
    #                              this stays 0 forever
    # degraded-mode accounting (never-crash serving; see ``handle``)
    breakdowns: int = 0          # requests rejected with BreakdownError
    bad_inputs: int = 0          # requests rejected with BadMatrixError
    failures: int = 0            # any other exception turned structured
    recovered: int = 0           # factors served WITH recorded perturbation/
    #                              shift recovery (solves auto-refine)
    dirty_evictions: int = 0     # factors evicted on a dirty guard report

    def throughput(self) -> dict:
        return {
            "factorizations_per_s": self.factorizations / max(self.factor_s, 1e-9),
            "solves_per_s": self.solves / max(self.solve_s, 1e-9),
            "factorizations": self.factorizations,
            "solves": self.solves,
            "factor_s": self.factor_s,
            "solve_s": self.solve_s,
            "repeat_rebuilds": self.repeat_rebuilds,
        }

    def degraded(self) -> dict:
        return {
            "breakdowns": self.breakdowns,
            "bad_inputs": self.bad_inputs,
            "failures": self.failures,
            "recovered": self.recovered,
            "dirty_evictions": self.dirty_evictions,
        }


class CholeskyServer:
    """Long-lived sparse-Cholesky service over one resident DeviceEngine.

    factor(A)        -> handle; repeat patterns hit the plan cache and skip
                        the symbolic phase entirely
    factor_many(As)  -> handle; M same-pattern matrices through ONE set of
                        fused multi-matrix dispatches
    solve(h, b)      -> solution(s) against the device-resident factor
                        (a resident tensor RHS in -> a resident solution
                        out, zero transfers)
    release(h)          drop a factor (bounded factor store)
    handle(kind, ...)   never-crash wrapper around the above: every request
                        returns a structured ``{"ok": ...}`` dict; guard
                        rejections, hostile inputs, and injected faults
                        become per-request failure results plus degraded-
                        mode counters instead of a dead server

    ``guard`` (default 'raise') is the breakdown policy applied to every
    factor request (repro_torch.core.guard); 'perturb' serves indefinite/singular
    inputs with recorded perturbations and refined solves.  Factors whose
    refined solves cannot reach DIRTY_RESID are evicted (``dirty_evictions``)
    so the stream re-factors instead of silently serving a degraded factor.
    ``max_cache_bytes`` bounds the plan cache (LRU demotion to disk).
    ``device`` is the engine's: the card unless ``"cpu"`` is given.
    """

    def __init__(self, *, cache_dir=None, device=None,
                 max_batch: int = 256, staging: str | None = None,
                 warm_buckets: tuple = ("fused",), verify: bool = False,
                 guard: str = "raise", max_cache_bytes: int | None = None):
        self.cache = PlanCache(cache_dir=cache_dir, warm_buckets=warm_buckets,
                               max_bytes=max_cache_bytes)
        self.engine = DeviceEngine(device=device)
        self.max_batch, self.staging = max_batch, staging
        self.guard = guard
        self.factors: dict = {}
        self._next_id = 0
        self.stats = ServeStats()
        # opt-in verification (repro_torch.analyze): every NEW pattern's plan
        # stack
        # is linted before it ever factors, and every factor request's event
        # trace is audited for staging hazards afterwards.  ERROR findings
        # raise (don't serve a wrong factor); the rest accumulate here.
        self.verify = verify
        self.verify_findings: list = []

    # -- request handlers ---------------------------------------------------
    def _plan_for(self, A):
        """Plan-cache lookup with the zero-rebuild guarantee enforced: a
        repeat pattern (memory OR disk hit) must not rebuild anything."""
        hits0 = self.cache.stats["hits"] + self.cache.stats["disk_hits"]
        before = counters.snapshot()
        plan = self.cache.get(A)
        hit = (self.cache.stats["hits"] + self.cache.stats["disk_hits"]) > hits0
        if hit:
            self.stats.repeat_rebuilds += sum(counters.delta(before).values())
        elif self.verify:
            self._verify_plan(plan)
        return plan

    # -- opt-in verification ------------------------------------------------
    def _record_findings(self, findings, what: str) -> None:
        self.verify_findings.extend(findings)
        errors = [f for f in findings if f.severity == "error"]
        if errors:
            raise RuntimeError(f"verification failed on {what}: {errors[0]}")

    def _verify_plan(self, plan) -> None:
        """Lint a freshly built plan stack before its first factorization."""
        from repro_torch.analyze import lint_plan_stack

        warmed = tuple(sorted({k[2] for k in (plan.sym.schedules or {})})) \
            or tuple(self.cache.warm_buckets)
        self._record_findings(
            lint_plan_stack(plan.sym, buckets=warmed,
                            fill=(plan.fill_src, plan.fill_dst),
                            nnz=plan.nnz),
            f"plan {plan.key[:12]}",
        )

    def _audit_factor(self, F) -> None:
        """Audit the engine's event trace recorded by this factor request."""
        from repro_torch.analyze import audit_engine

        stats = getattr(F, "stats", None) or {}
        self._record_findings(
            audit_engine(self.engine, staging=stats.get("staging", "async")),
            "event trace",
        )

    def _store(self, F):
        fid = self._next_id
        self._next_id += 1
        self.factors[fid] = F
        return fid

    def factor(self, A: sp.spmatrix) -> int:
        t0 = time.perf_counter()
        plan = self._plan_for(A)
        F = cholesky(A, plan=plan, device_engine=self.engine,
                     max_batch=self.max_batch, staging=self.staging,
                     guard=self.guard)
        if self.verify:
            self._audit_factor(F)
        self.stats.factor_s += time.perf_counter() - t0
        self.stats.factorizations += 1
        self.stats.factor_requests += 1
        if F.guard_report is not None and F.guard_report.needs_refine:
            self.stats.recovered += 1
        return self._store(F)

    def factor_many(self, As) -> int:
        As = list(As)
        t0 = time.perf_counter()
        plan = self._plan_for(As[0])
        # 'shift' is a single-matrix retry loop; batches detect via 'raise'
        guard = self.guard if self.guard != "shift" else "raise"
        F = cholesky_many(As, plan=plan, device_engine=self.engine,
                          max_batch=self.max_batch, staging=self.staging,
                          guard=guard)
        if self.verify:
            self._audit_factor(F)
        self.stats.factor_s += time.perf_counter() - t0
        self.stats.factorizations += len(As)
        self.stats.factor_requests += 1
        if F.guard_reports and any(r.needs_refine for r in F.guard_reports):
            self.stats.recovered += 1
        return self._store(F)

    def solve(self, handle: int, b):
        """Solve against a resident factor.  ``b``: (n,)/(n, k) for a single
        factor, (M, n)/(M, n, k) for a batch handle; a resident tensor on
        the engine's device stays resident (zero transfers).  Perturbed/shifted factors refine
        toward the original system; a factor whose refinement cannot reach
        DIRTY_RESID is evicted after serving (best effort, never reused)."""
        F = self.factors[handle]
        rep = getattr(F, "guard_report", None)
        if rep is not None and not rep.ok:
            # defense in depth: never serve from a factor known broken
            self.release(handle)
            self.stats.dirty_evictions += 1
            raise BreakdownError(rep)
        t0 = time.perf_counter()
        if hasattr(F, "nmat"):  # BatchCholeskyFactor
            if F.guard_reports and any(r.needs_refine for r in F.guard_reports):
                # per-matrix refined solves toward the original systems
                b = np.asarray(b)
                x = np.stack([F.factor(i).solve(b[i]) for i in range(F.nmat)])
            else:
                x = F.solve(b)
            ncol = F.nmat * (1 if b.ndim == 2 else int(b.shape[-1]))
        else:
            x = F.solve(b, backend="device", engine=self.engine)
            ncol = 1 if b.ndim == 1 else int(b.shape[-1])
        self.stats.solve_s += time.perf_counter() - t0
        self.stats.solves += ncol
        self.stats.solve_requests += 1
        if self._refine_stalled(F):
            self.release(handle)
            self.stats.dirty_evictions += 1
        return x

    @staticmethod
    def _refine_stalled(F) -> bool:
        """True when the factor's most recent refined solve stalled above
        DIRTY_RESID (the factor is 'dirty': best-effort result, evict)."""
        reps = (F.guard_reports if getattr(F, "guard_reports", None)
                else [getattr(F, "guard_report", None)])
        for rep in reps:
            if rep is None or not rep.ir_history:
                continue
            hist = rep.ir_history[-1]
            if hist and hist[-1] > DIRTY_RESID:
                rep.downgrades += 1
                return True
        return False

    def release(self, handle: int) -> None:
        self.factors.pop(handle, None)

    # -- never-crash request surface ----------------------------------------
    def handle(self, kind: str, *args, **kw) -> dict:
        """Serve one request, never raising: returns ``{"ok": True,
        "result": ...}`` or ``{"ok": False, "error": {...}}`` with the
        failure classified (breakdown / bad_input / failure) and counted.
        A guarded rejection carries the structured GuardReport dict."""
        ops = {"factor": self.factor, "factor_many": self.factor_many,
               "solve": self.solve, "release": self.release}
        if kind not in ops:
            self.stats.failures += 1
            return {"ok": False, "error": {"kind": "failure",
                                           "type": "ValueError",
                                           "message": f"unknown request kind {kind!r}"}}
        try:
            return {"ok": True, "result": ops[kind](*args, **kw)}
        except BreakdownError as e:
            self.stats.breakdowns += 1
            return {"ok": False, "error": {
                "kind": "breakdown", "type": "BreakdownError",
                "message": str(e), "report": e.report.to_dict()}}
        except BadMatrixError as e:
            self.stats.bad_inputs += 1
            return {"ok": False, "error": {
                "kind": "bad_input", "type": "BadMatrixError",
                "message": str(e), "validation": e.validation}}
        except Exception as e:  # noqa: BLE001 — never-crash serving surface
            self.stats.failures += 1
            return {"ok": False, "error": {
                "kind": "failure", "type": type(e).__name__,
                "message": str(e)}}

    def report(self) -> dict:
        rep = self.stats.throughput()
        rep["cache"] = dict(self.cache.stats)
        rep["patterns"] = len(self.cache)
        rep["engine"] = dict(self.engine.stats)
        rep["guard"] = self.guard
        rep["degraded"] = self.stats.degraded()
        rep["fallbacks"] = dict(self.engine.fallbacks)
        if self.verify:
            by_sev: dict = {}
            for f in self.verify_findings:
                by_sev[f.severity] = by_sev.get(f.severity, 0) + 1
            rep["verify"] = by_sev
        return rep


# ---------------------------------------------------------------------------
# synthetic request stream
# ---------------------------------------------------------------------------
def _grid_laplacian(k: int, shift: float) -> sp.csc_matrix:
    """2-D grid Laplacian + shift*I — one pattern per k, fresh values per
    shift (the diagonal is in the pattern, so every shift shares the plan)."""
    from repro_torch.sparse.gen import laplacian_2d

    A = laplacian_2d(k)
    return sp.csc_matrix(A + shift * sp.eye(A.shape[0]))


def synthetic_stream(*, requests: int, patterns: int, grid: int, many: int,
                     nrhs: int = 4, seed: int = 0) -> list:
    """A serving trace: each pattern's FIRST factor request is a cache miss;
    later requests on it are repeat-pattern factors (probability ~1/2),
    batched repeat-pattern factors (~1/4), or solve-only (~1/4)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(patterns):  # every pattern enters the cache first
        reqs.append(("factor", i, 1))
    for _ in range(max(0, requests - patterns)):
        pat = int(rng.integers(patterns))
        r = rng.random()
        if r < 0.5:
            reqs.append(("factor", pat, 1))
        elif r < 0.75:
            reqs.append(("factor_many", pat, many))
        else:
            reqs.append(("solve", pat, nrhs))
    return reqs


def run_stream(srv: CholeskyServer, reqs: list, *, grid: int, seed: int = 0,
               check: bool = True, mutate=None) -> dict:
    """Execute a synthetic trace against a server through the never-crash
    ``handle`` surface; returns the report (with per-kind request counts,
    rejected-request count, and, with ``check``, the max residual over
    successful solves).  ``mutate(i, A) -> A'`` lets chaos tests corrupt the
    i-th request's matrix (hostile/indefinite inputs) — a rejection then
    shows up in the report's degraded counters, never as an exception."""
    rng = np.random.default_rng(seed)
    last_handle: dict = {}     # pattern -> (handle, A or [As])
    shift = {}
    max_resid = 0.0
    kinds = {"factor": 0, "factor_many": 0, "solve": 0}
    rejected = 0
    for i, (kind, pat, m) in enumerate(reqs):
        k = grid + pat          # distinct grid size per pattern
        shift[pat] = shift.get(pat, 0.0) + 0.25
        kinds[kind] += 1
        if kind == "factor":
            A = _grid_laplacian(k, 1.0 + shift[pat])
            if mutate is not None:
                A = mutate(i, A)
            res = srv.handle("factor", A)
            if res["ok"]:
                last_handle[pat] = (res["result"], A)
            else:
                rejected += 1
        elif kind == "factor_many":
            As = [_grid_laplacian(k, 1.0 + shift[pat] + 0.1 * j)
                  for j in range(m)]
            res = srv.handle("factor_many", As)
            if res["ok"]:
                last_handle[pat] = (res["result"], As)
            else:
                rejected += 1
        else:
            if pat not in last_handle:
                continue
            h, stored = last_handle[pat]
            if isinstance(stored, list):
                n = stored[0].shape[0]
                b = rng.standard_normal((len(stored), n, m))
            else:
                n = stored.shape[0]
                b = rng.standard_normal((n, m))
            res = srv.handle("solve", h, b)
            if not res["ok"]:
                rejected += 1
                last_handle.pop(pat, None)  # handle may have been evicted
                continue
            x = res["result"]
            if check:
                if isinstance(stored, list):
                    r = max(
                        float(np.linalg.norm(Ai @ xi - bi)
                              / max(np.linalg.norm(bi), 1e-30))
                        for Ai, xi, bi in zip(stored, x, b)
                    )
                else:
                    r = float(np.linalg.norm(stored @ x - b)
                              / max(np.linalg.norm(b), 1e-30))
                max_resid = max(max_resid, r)
    rep = srv.report()
    rep["requests"] = kinds
    rep["rejected"] = rejected
    if check:
        rep["max_solve_resid"] = max_resid
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--patterns", type=int, default=3)
    ap.add_argument("--grid", type=int, default=14,
                    help="smallest grid side; pattern i uses (grid+i)^2 rows")
    ap.add_argument("--many", type=int, default=4,
                    help="matrices per batched factor request")
    ap.add_argument("--nrhs", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or the kernels' plain "
                         "versions on the host")
    ap.add_argument("--guard", default="raise",
                    choices=["off", "raise", "perturb", "shift"],
                    help="breakdown policy for factor requests")
    ap.add_argument("--max-cache-bytes", type=int, default=None,
                    help="LRU bound on the in-memory plan cache")
    ap.add_argument("--cache-dir", default=None,
                    help="persist plans to disk (cross-process reuse)")
    ap.add_argument("--verify", action="store_true",
                    help="lint every new pattern's plan stack and audit "
                         "every factor's event trace (repro_torch.analyze)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    srv = CholeskyServer(cache_dir=args.cache_dir, device=args.device,
                         verify=args.verify, guard=args.guard,
                         max_cache_bytes=args.max_cache_bytes)
    reqs = synthetic_stream(
        requests=args.requests, patterns=args.patterns, grid=args.grid,
        many=args.many, nrhs=args.nrhs, seed=args.seed,
    )
    rep = run_stream(srv, reqs, grid=args.grid, seed=args.seed)
    print(f"[serve] {sum(rep['requests'].values())} requests "
          f"({rep['requests']}) over {rep['patterns']} patterns")
    print(f"  factorizations: {rep['factorizations']} in {rep['factor_s']:.2f}s "
          f"({rep['factorizations_per_s']:.2f}/s)")
    print(f"  solves:         {rep['solves']} RHS in {rep['solve_s']:.2f}s "
          f"({rep['solves_per_s']:.2f}/s)")
    print(f"  plan cache:     {rep['cache']} "
          f"repeat_rebuilds={rep['repeat_rebuilds']}")
    print(f"  guard={rep['guard']}  degraded: {rep['degraded']}  "
          f"fallbacks: {rep['fallbacks']}  rejected={rep['rejected']}")
    print(f"  max solve resid: {rep.get('max_solve_resid', float('nan')):.2e}")
    if "verify" in rep:
        print(f"  verification:   findings by severity {rep['verify']}")


if __name__ == "__main__":
    main()
