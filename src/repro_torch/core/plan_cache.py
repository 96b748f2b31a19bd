"""Pattern-keyed plan cache: amortize the symbolic phase across requests.

Port of ``src/repro/core/plan_cache.py``.  The fingerprint and the fill plan
are the reference's bit for bit; the file format is the port's own: the
reference pickles its own ``SymbolicFactor`` class, so unpickling one of its
files would import the JAX package, and this module never does.  The
envelope names the format (``FORMAT``) and is checked before the payload is
unpickled, so a reference file is rejected unread.

Production streams (Newton/IPM outer loops, per-user graph Laplacians over
one topology) are dominated by *repeated sparsity patterns*: the values
change every request, the pattern almost never does.  The symbolic phase —
ordering, elimination tree, supernode detection, merge/refine, scatter plan,
level schedule, device index plan — depends only on the pattern, and on this
codebase it is host-side Python, often costing more than the numeric phase
it plans.  This module keys all of it on a *pattern fingerprint* so a repeat
pattern performs ZERO rebuilds (enforced against repro_torch.core.counters):

    cache = PlanCache()
    plan = cache.get(A)              # miss: full analysis, warmed + cached
    F = cholesky(A2, plan=plan)      # same pattern, new values: numeric only
    Fs = cholesky_many([A2, A3], plan=plan)   # M matrices, one dispatch set

Beyond the symbolic artifacts, a CachedPlan carries a *fill plan*: a pair of
index arrays mapping the canonical CSC data array of ANY matrix with this
pattern straight into the flat PanelStore storage
(``storage[fill_dst] = A.data[fill_src]``).  This replaces both the
matrix permutation ``A[p][:, p]`` and the per-supernode Python fill loop
(``numeric._fill_panels``) with one vectorized gather — the last remaining
per-request host cost that scaled with pattern size.

Serialization: ``save``/``load`` round-trip a CachedPlan through a single
file, so repeat patterns skip analysis *across processes* too (a server
restart, a fleet of workers sharing a warmed cache directory).  The format
is a pickle of plain numpy/dataclass state (protocol 4); everything staged
is host-side — device buffers are never cached here.  Loading a plan and
factoring through it is bit-identical to the in-process path because the
numeric phase consumes exactly the same index arrays either way (asserted
in tests/test_torch_many.py).
"""
from __future__ import annotations

import hashlib
import pathlib
import pickle
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from repro_torch.core import counters
from repro_torch.core.relind import scatter_plan
from repro_torch.core.schedule import cached_schedule
from repro_torch.core.symbolic import SymbolicFactor

#: the envelope's format name: a file without it (the reference's) is
#: rejected before its payload is unpickled
FORMAT = "repro_torch.plan"
#: bump when the CachedPlan layout changes; stale files are rejected on load.
#: The envelope {format, version, key, digest, blob} carries a blake2b digest
#: that detects corrupt/tampered files before anything is unpickled into the
#: numeric phase.
FORMAT_VERSION = 1


def canonical_csc(A: sp.spmatrix) -> sp.csc_matrix:
    """CSC with sorted indices and no duplicates — the canonical form every
    fingerprint and fill plan is defined against."""
    A = sp.csc_matrix(A)
    A.sum_duplicates()
    A.sort_indices()
    return A


def pattern_fingerprint(A: sp.spmatrix) -> str:
    """Hex digest of the sparsity pattern (shape + indptr + indices) of the
    canonical CSC form.  Values are deliberately NOT hashed: two matrices
    with the same pattern share every symbolic artifact."""
    A = canonical_csc(A)
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(A.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def build_fill_plan(sym: SymbolicFactor, A: sp.csc_matrix) -> tuple:
    """Index arrays (fill_src, fill_dst) such that, for any matrix sharing
    A's pattern in canonical CSC form,

        storage[fill_dst] = M.data[fill_src]

    reproduces ``numeric.init_panel_store(sym, Mperm).storage`` exactly
    (same cells, same values — the composition of the symmetric
    permutation ``M[p][:, p]`` and the per-supernode panel fill).
    """
    counters.bump("fill_plan")
    A = canonical_csc(A)
    n = sym.n
    p = sym.perm
    # track where each canonical data slot lands under the permutation:
    # entry k of the permuted matrix came from slot src_of_perm[k].  1-based
    # payload so structural zeros cannot be confused with real entries
    # (float64 is exact far beyond any realistic nnz).
    tracker = sp.csc_matrix(
        (np.arange(1, A.nnz + 1, dtype=np.float64), A.indices, A.indptr),
        shape=A.shape,
    )
    T = tracker[p][:, p].tocsc()
    T.sort_indices()
    src_of_perm = np.rint(T.data).astype(np.int64) - 1
    # replicate the _fill_panels index computation once, vectorized per column
    plan = scatter_plan(sym)
    offs = plan.offs
    Tp, Ti = T.indptr, T.indices
    srcs: list = []
    dsts: list = []
    for s in range(sym.nsuper):
        f = int(sym.super_ptr[s])
        w = sym.width(s)
        r = sym.rows[s]
        for c in range(w):
            j = f + c
            lo, hi = Tp[j], Tp[j + 1]
            rows_j = Ti[lo:hi]
            keep = rows_j >= j
            pos = np.searchsorted(r, rows_j[keep])
            srcs.append(src_of_perm[lo:hi][keep])
            dsts.append(offs[s] + pos * w + c)
    fill_src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    fill_dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    return fill_src, fill_dst


@dataclass
class CachedPlan:
    """Everything the numeric phase needs for one sparsity pattern.

    ``sym`` arrives with its lazily-built artifacts (scatter plan, level
    schedules, device index plans) attached, so every ``cholesky``/
    ``cholesky_many``/solve through this plan reuses them; ``warm`` forces
    the builds eagerly so a saved plan is complete and a loaded one never
    rebuilds anything.
    """
    key: str
    sym: SymbolicFactor
    fill_src: np.ndarray
    fill_dst: np.ndarray
    n: int
    nnz: int
    version: int = FORMAT_VERSION
    # request-stream accounting (not serialized state worth keeping exact;
    # reset on load)
    uses: int = field(default=0, compare=False)

    def fill_storage(self, A: sp.spmatrix, out: np.ndarray | None = None,
                     *, row: np.ndarray | None = None) -> np.ndarray:
        """Vectorized PanelStore fill: permute + scatter A's values into the
        flat storage layout with one gather (``row`` writes into an existing
        storage row in place — the multi-matrix staging path)."""
        data = self.values_of(A)
        if row is not None:
            row[self.fill_dst] = data[self.fill_src]
            return row
        if out is None:
            out = np.zeros(int(scatter_plan(self.sym).storage_cells),
                           dtype=np.float64)
        out[self.fill_dst] = data[self.fill_src]
        return out

    def values_of(self, A: sp.spmatrix) -> np.ndarray:
        """Canonical-CSC data array of ``A``, pattern-checked against this
        plan (cheap: nnz + shape; full fingerprinting is the caller's
        opt-in via ``pattern_fingerprint``)."""
        A = canonical_csc(A)
        if A.shape[0] != self.n or A.nnz != self.nnz:
            raise ValueError(
                f"matrix ({A.shape[0]}, nnz={A.nnz}) does not match the "
                f"cached pattern (n={self.n}, nnz={self.nnz})"
            )
        return np.asarray(A.data, dtype=np.float64)

    def warm(self, *, buckets: tuple = ("fused",), max_batch: int = 256) -> "CachedPlan":
        """Eagerly build the scatter plan, the level schedule(s), and their
        device index plans so nothing is rebuilt later (and a ``save`` below
        captures the complete plan).  ``buckets`` names the schedule
        families to warm — 'fused' serves the port's device-resident path,
        'batch' the device solve of a host factor."""
        from repro_torch.core.device_store import device_plan

        scatter_plan(self.sym)
        for bucket in buckets:
            sched = cached_schedule(self.sym, max_batch=max_batch, bucket=bucket)
            device_plan(self.sym, sched)
        return self

    # -- serialization ------------------------------------------------------
    def save(self, path) -> pathlib.Path:
        """Write this plan to ``path`` (a file, or a directory to use the
        canonical ``plan_<key>.pkl`` name)."""
        path = pathlib.Path(path)
        if path.is_dir():
            path = path / f"plan_{self.key}.pkl"
        blob = pickle.dumps({
            "key": self.key, "n": self.n, "nnz": self.nnz,
            "sym": self.sym, "fill_src": self.fill_src,
            "fill_dst": self.fill_dst,
        }, protocol=4)
        envelope = {
            "format": FORMAT, "version": FORMAT_VERSION, "key": self.key,
            "digest": hashlib.blake2b(blob, digest_size=16).hexdigest(),
            "blob": blob,
        }
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(envelope, f, protocol=4)
        tmp.replace(path)  # atomic publish: concurrent readers never see a
        # half-written plan
        return path

    @staticmethod
    def load(path, *, expect_key: str | None = None,
             lint: bool = False) -> "CachedPlan":
        """Load a saved plan, rejecting anything that should not reach the
        numeric phase: a stale format version, a corrupt/tampered file (the
        envelope digest no longer matches the payload), or — with
        ``expect_key`` — a plan for a different sparsity pattern.  These
        fail HERE with a clear error instead of deep in factorize_levels.
        ``lint=True`` additionally runs the plan lint
        (``repro_torch.analyze.plan_lint``) over the loaded plan and raises
        ValueError on an error finding."""
        with open(path, "rb") as f:
            envelope = pickle.load(f)
        if not isinstance(envelope, dict) or envelope.get("format") != FORMAT:
            got = envelope.get("format") if isinstance(envelope, dict) else None
            raise ValueError(
                f"plan file {path} has format {got!r}, want {FORMAT!r}"
            )
        if envelope.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"plan file {path} has format version "
                f"{envelope.get('version')!r}, want {FORMAT_VERSION}"
            )
        blob = envelope.get("blob")
        digest = (hashlib.blake2b(blob, digest_size=16).hexdigest()
                  if isinstance(blob, bytes) else None)
        if digest is None or digest != envelope.get("digest"):
            raise ValueError(
                f"plan file {path} is corrupt: payload digest "
                f"{digest} does not match envelope digest "
                f"{envelope.get('digest')!r}"
            )
        payload = pickle.loads(blob)
        key = payload["key"]
        if key != envelope.get("key"):
            raise ValueError(
                f"plan file {path} is corrupt: payload key {key} does not "
                f"match envelope key {envelope.get('key')!r}"
            )
        if expect_key is not None and key != expect_key:
            raise ValueError(
                f"plan file {path} holds pattern fingerprint {key}, "
                f"expected {expect_key} — wrong plan for this matrix"
            )
        plan = CachedPlan(
            key=key, sym=payload["sym"],
            fill_src=payload["fill_src"], fill_dst=payload["fill_dst"],
            n=payload["n"], nnz=payload["nnz"],
        )
        if lint:
            from repro_torch.analyze.plan_lint import lint_plan_stack

            warmed = sorted({k[2] for k in (plan.sym.schedules or {})})
            findings = lint_plan_stack(
                plan.sym, buckets=tuple(warmed),
                fill=(plan.fill_src, plan.fill_dst), nnz=plan.nnz,
            )
            errors = [f for f in findings if f.severity == "error"]
            if errors:
                raise ValueError(
                    f"plan file {path} failed plan lint: {errors[0]}"
                )
        return plan


def _plan_nbytes(plan: CachedPlan) -> int:
    """Estimated host-memory footprint of a CachedPlan: the fill plan plus
    the symbolic factor's index arrays (the dominant terms; lazily-built
    schedule/device-plan artifacts are bounded by the same order)."""
    nb = int(plan.fill_src.nbytes) + int(plan.fill_dst.nbytes)
    sym = plan.sym
    for name in ("perm", "parent", "super_ptr", "snode", "sparent"):
        arr = getattr(sym, name, None)
        if arr is not None:
            nb += int(np.asarray(arr).nbytes)
    for r in sym.rows:
        nb += int(np.asarray(r).nbytes)
    return nb


class PlanCache:
    """In-memory pattern -> CachedPlan map with optional disk persistence.

    ``get(A)`` fingerprints the pattern and returns the cached plan on a
    hit; on a miss it runs the full symbolic pipeline, warms the plan, and
    (with a ``cache_dir``) persists it.  A second process pointed at the
    same directory loads instead of rebuilding — its first request is a
    *disk hit* (zero analysis builds), not a miss.

    ``max_bytes`` bounds the in-memory footprint: plans are kept in LRU
    order and the least-recently-used ones are dropped from memory once the
    estimated total exceeds the budget (``stats["evictions"]`` counts
    drops).  Eviction is a *demotion*, not a loss: with a ``cache_dir`` the
    persisted file remains, so a re-request is a disk hit, and without one
    it is an ordinary rebuild miss.  The most recent plan is never evicted.
    """

    def __init__(self, cache_dir=None, *, ordering: str = "nd",
                 merge: bool = True, refine: bool = True,
                 warm_buckets: tuple = ("fused",),
                 max_bytes: int | None = None):
        self.cache_dir = pathlib.Path(cache_dir) if cache_dir else None
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.ordering, self.merge, self.refine = ordering, merge, refine
        self.warm_buckets = warm_buckets
        self.max_bytes = max_bytes
        self._mem: OrderedDict[str, CachedPlan] = OrderedDict()
        self._sizes: dict[str, int] = {}
        self.stats = {"hits": 0, "misses": 0, "disk_hits": 0, "evictions": 0}
        # rejected disk loads (stale format / corrupt / wrong pattern) — kept
        # out of ``stats`` so existing exact-equality assertions stay valid
        self.disk_rejects = 0

    def __len__(self) -> int:
        return len(self._mem)

    def nbytes(self) -> int:
        """Estimated in-memory footprint of the cached plans."""
        return sum(self._sizes.values())

    def _path(self, key: str) -> pathlib.Path | None:
        return None if self.cache_dir is None else self.cache_dir / f"plan_{key}.pkl"

    def _admit(self, key: str, plan: CachedPlan) -> None:
        self._mem[key] = plan
        self._mem.move_to_end(key)
        self._sizes[key] = _plan_nbytes(plan)
        if self.max_bytes is None:
            return
        while len(self._mem) > 1 and self.nbytes() > self.max_bytes:
            old, _ = self._mem.popitem(last=False)
            self._sizes.pop(old, None)
            self.stats["evictions"] += 1

    def get(self, A: sp.spmatrix) -> CachedPlan:
        key = pattern_fingerprint(A)
        plan = self._mem.get(key)
        if plan is not None:
            self.stats["hits"] += 1
            plan.uses += 1
            self._mem.move_to_end(key)  # LRU touch
            return plan
        path = self._path(key)
        if path is not None and path.exists():
            try:
                # the key doubles as the pattern fingerprint, so load-time
                # validation proves the file matches THIS matrix's pattern
                plan = CachedPlan.load(path, expect_key=key)
            except (ValueError, pickle.UnpicklingError, EOFError, OSError):
                # stale format / corrupt / mismatched file: rebuild and
                # overwrite rather than factoring garbage or crashing a
                # long-lived server on a cache-format upgrade
                self.disk_rejects += 1
            else:
                self.stats["disk_hits"] += 1
                plan.uses += 1
                self._admit(key, plan)
                return plan
        self.stats["misses"] += 1
        plan = self.build(A, key=key)
        self._admit(key, plan)
        if path is not None:
            plan.save(path)
        return plan

    def build(self, A: sp.spmatrix, *, key: str | None = None) -> CachedPlan:
        """Full symbolic pipeline + fill plan + warm (a forced miss)."""
        from repro_torch.core.api import symbolic_pipeline

        A = canonical_csc(A)
        if key is None:
            key = pattern_fingerprint(A)
        sym, _Aperm = symbolic_pipeline(
            A, ordering=self.ordering, merge=self.merge, refine=self.refine
        )
        fill_src, fill_dst = build_fill_plan(sym, A)
        plan = CachedPlan(
            key=key, sym=sym, fill_src=fill_src, fill_dst=fill_dst,
            n=A.shape[0], nnz=int(A.nnz), uses=1,
        )
        plan.warm(buckets=self.warm_buckets)
        return plan
