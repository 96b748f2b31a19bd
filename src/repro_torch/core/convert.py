"""Carry the reference's symbolic state across into the port.

The reference's ``SymbolicFactor`` and flat panel storage are plain numpy
fields, so they cross as arrays: ``symbolic_from_arrays`` builds the port's
``SymbolicFactor`` from them, ``storage_from_array`` takes over a flat
storage array, and ``cached_plan_from_arrays`` builds the port's
``CachedPlan`` from a reference plan's key, symbolic fields and fill plan
(its pickled files name the reference's classes and are never loaded).  Handing one analysis to both packages lets two runs be
compared cell for cell — the solver's counterpart of carrying weights
across.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.numeric import PanelStore
from repro_torch.core.plan_cache import CachedPlan
from repro_torch.core.symbolic import SymbolicFactor


def symbolic_from_arrays(n, perm, parent, super_ptr, rows, snode, sparent,
                         colcount=None) -> SymbolicFactor:
    """A port ``SymbolicFactor`` from the reference's fields (copied, int64)."""
    as64 = lambda a: np.array(a, dtype=np.int64)  # noqa: E731
    sym = SymbolicFactor(
        n=int(n), perm=as64(perm), parent=as64(parent),
        super_ptr=as64(super_ptr), rows=[as64(r) for r in rows],
        snode=as64(snode), sparent=as64(sparent),
        colcount=None if colcount is None else as64(colcount),
    )
    sym.validate()
    return sym


def storage_from_array(flat, sym: SymbolicFactor | None = None):
    """A float64 copy of a flat panel storage array; with ``sym``, wrapped in
    a ``PanelStore`` whose panels are views into it (the length must match
    that factor's layout)."""
    storage = np.array(flat, dtype=np.float64).reshape(-1)
    if sym is None:
        return storage
    store = PanelStore(sym, storage=storage)
    if storage.shape[0] != store.plan.storage_cells:
        raise ValueError(
            f"storage has {storage.shape[0]} cells, the factor needs "
            f"{store.plan.storage_cells}"
        )
    return store


def cached_plan_from_arrays(key: str, fill_src, fill_dst, n: int, nnz: int,
                            **sym_fields) -> CachedPlan:
    """A port ``CachedPlan`` from a reference plan's arrays: its pattern
    key, its fill plan (``fill_src``, ``fill_dst``), ``n`` and ``nnz``, and
    the ``symbolic_from_arrays`` fields of its ``sym`` (``n`` of the
    symbolic factor is the plan's ``n``)."""
    sym = symbolic_from_arrays(n=n, **sym_fields)
    return CachedPlan(key=str(key), sym=sym,
                      fill_src=np.array(fill_src, dtype=np.int64),
                      fill_dst=np.array(fill_dst, dtype=np.int64),
                      n=int(n), nnz=int(nnz))
