"""Sparse-matrix substrate: CSC utilities, test-matrix generators, fill-reducing orderings."""
from repro_torch.sparse.gen import (
    laplacian_2d,
    laplacian_3d,
    elasticity_3d,
    kkt_like,
    random_spd,
    MATRIX_SUITE,
    make_suite_matrix,
)
from repro_torch.sparse.ordering import nested_dissection, rcm_ordering, natural_ordering, fill_reducing_ordering

__all__ = [
    "laplacian_2d",
    "laplacian_3d",
    "elasticity_3d",
    "kkt_like",
    "random_spd",
    "MATRIX_SUITE",
    "make_suite_matrix",
    "nested_dissection",
    "rcm_ordering",
    "natural_ordering",
    "fill_reducing_ordering",
]
