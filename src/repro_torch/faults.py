"""Deterministic fault injection for the factorization stack (port of
``src/repro/faults.py``).

A :class:`FaultPlan` attaches to a ``DeviceEngine`` (``engine.faults = plan``)
and fires through three hooks the engine exposes:

    on_put(engine, x)            every float host->device upload (staged
                                 storage chunks, panels) — may return a
                                 corrupted replacement
    on_dispatch(engine, lvl)     immediately before each first-tier fused
                                 group dispatch — may raise, which exercises
                                 the cuda -> plain -> host fallback chain
    on_group_result(engine, out, pool, lvl)
                                 after a group completes (any tier) — may
                                 corrupt the result, simulating silent
                                 device memory corruption that fallback can
                                 NOT catch (only the in-kernel guards can)

The port writes the update pool in place and its group dispatch returns no
pool, so ``on_group_result`` receives the pool and poisons it in place.

Everything is deterministic: injectors fire on exact ordinals (the Nth
upload, the Nth dispatch) or exact levels, and every firing is recorded in
``plan.fired`` so tests can assert the fault actually happened.  Matrix- and
file-level injectors (:func:`make_indefinite`, :func:`poison_plan_file`)
need no hooks and corrupt the input/cache artifacts directly.
"""
from __future__ import annotations

import pathlib

import numpy as np
import scipy.sparse as sp

__all__ = [
    "InjectedDispatchError",
    "FaultPlan",
    "make_indefinite",
    "nan_segment",
    "poison_plan_file",
]


class InjectedDispatchError(RuntimeError):
    """Raised by FaultPlan.on_dispatch to simulate a failed device dispatch
    (driver fault, out of memory, a launch error)."""


class FaultPlan:
    """Deterministic fault schedule wired through the DeviceEngine hooks.

    fail_dispatch    1-indexed ordinal of the fused-group dispatch to fail
                     with InjectedDispatchError (first tier only, so the
                     engine's fallback chain absorbs it); ``fail_always``
                     makes every dispatch from that ordinal on fail, which
                     drives the chain all the way to the host tier
    corrupt_upload   1-indexed ordinal of the float upload to NaN-poison
                     (simulates a corrupted staged storage chunk; every
                     tier then sees the bad values, so only the in-kernel
                     guards catch it)
    nan_pool_level   level after whose first completed group the update pool
                     is NaN-poisoned (silent corruption *after* a successful
                     dispatch; later levels consume the poisoned updates)
    """

    def __init__(self, *, fail_dispatch: int | None = None,
                 fail_always: bool = False,
                 corrupt_upload: int | None = None,
                 nan_pool_level: int | None = None):
        self.fail_dispatch = fail_dispatch
        self.fail_always = fail_always
        self.corrupt_upload = corrupt_upload
        self.nan_pool_level = nan_pool_level
        self.n_put = 0
        self.n_dispatch = 0
        self.fired: list = []

    # -- engine hooks -------------------------------------------------------
    def on_put(self, engine, x: np.ndarray) -> np.ndarray:
        if not np.issubdtype(np.asarray(x).dtype, np.floating):
            return x
        self.n_put += 1
        if self.corrupt_upload is not None and self.n_put == self.corrupt_upload:
            self.fired.append(("corrupt_upload", self.n_put))
            return nan_segment(np.array(x, dtype=np.float64, copy=True))
        return x

    def on_dispatch(self, engine, lvl: int) -> None:
        self.n_dispatch += 1
        if self.fail_dispatch is None:
            return
        hit = (self.n_dispatch >= self.fail_dispatch if self.fail_always
               else self.n_dispatch == self.fail_dispatch)
        if hit:
            self.fired.append(("fail_dispatch", self.n_dispatch, lvl))
            raise InjectedDispatchError(
                f"injected dispatch failure #{self.n_dispatch} (level {lvl})"
            )

    def on_group_result(self, engine, out, pool, lvl: int):
        if (self.nan_pool_level is None or lvl != self.nan_pool_level
                or any(f[0] == "nan_pool" for f in self.fired)):
            return out
        # poison the whole pool so whatever segments later levels gather
        # from are guaranteed nonfinite
        self.fired.append(("nan_pool", lvl))
        pool.fill_(float("nan"))
        return out


# -- input / artifact injectors ---------------------------------------------
def make_indefinite(A: sp.spmatrix, i: int = 0, value: float = -50.0):
    """Copy of symmetric ``A`` with diagonal entry ``i`` forced to ``value``
    (negative => the supernode holding column ``i`` breaks down)."""
    B = sp.lil_matrix(A.copy())
    B[i, i] = value
    B = B.tocsc()
    B.sort_indices()
    return B


def nan_segment(x: np.ndarray, frac: float = 0.25) -> np.ndarray:
    """NaN-poison the leading ``frac`` of a float array, in place."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    flat[:k] = np.nan
    return x


def poison_plan_file(path) -> None:
    """Overwrite a cached plan file (``plan_<key>.pkl``, or the first under
    a directory) with garbage bytes.  PlanCache must reject it on load and
    rebuild instead of factoring garbage."""
    p = pathlib.Path(path)
    if p.is_dir():
        files = sorted(p.glob("plan_*.pkl"))
        if not files:
            raise FileNotFoundError(f"no plan files under {p}")
        p = files[0]
    p.write_bytes(b"\x80\x04garbage-not-a-plan" + b"\x00" * 64)
