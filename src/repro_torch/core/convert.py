"""Carry the reference's symbolic state across into the port.

The reference's ``SymbolicFactor`` and flat panel storage are plain numpy
fields, so they cross as arrays: ``symbolic_from_arrays`` builds the port's
``SymbolicFactor`` from them and ``storage_from_array`` takes over a flat
storage array.  Handing one analysis to both packages lets two runs be
compared cell for cell — the solver's counterpart of carrying weights
across.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.numeric import PanelStore
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
