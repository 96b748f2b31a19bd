"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it in the same module:

    fused  — batched POTRF + TRSM + SYRK over a (level x bucket) group,
             unguarded and guarded (the pivot clamp and status row)
             (replaces src/repro/kernels/fused.py::fused_factor_syrk)
    trsm   — batched lower-triangular inverse of diagonal blocks, and the
             general right-side solve X L^T = B
             (replace src/repro/kernels/trsm.py::trsm_rlt)
    potrf  — Cholesky of one diagonal tile, and the blocked routine over it
             (replaces src/repro/kernels/potrf.py::chol_tile / potrf)
    syrk   — C = tril(A A^T), and C -= A A^T on the lower triangle in
             place (replaces src/repro/kernels/syrk.py::syrk_ln)
    gemm   — C = A B^T         (replaces src/repro/kernels/gemm.py::gemm_nt)

``ops`` chains them into the sequential path's dense operations (the
blocked ``potrf`` routine is ``ops.potrf``).  A wrapper
runs the plain version for a CPU tensor and launches its kernel, or raises,
for a CUDA tensor.  ``_build`` compiles ``csrc/*.cu`` at first use.
"""
from repro_torch.kernels._build import KernelBuildError
from repro_torch.kernels.fused import (
    fused_factor_syrk,
    fused_factor_syrk_guarded,
    fused_factor_syrk_guarded_ref,
    fused_factor_syrk_ref,
    live_cells,
)
from repro_torch.kernels.gemm import gemm_nt, gemm_nt_ref
from repro_torch.kernels.potrf import chol_tile, chol_tile_ref, potrf_ref
from repro_torch.kernels.syrk import (
    syrk_ln,
    syrk_ln_ref,
    syrk_ln_sub,
    syrk_ln_sub_ref,
)
from repro_torch.kernels.trsm import (
    tri_inv_lower,
    tri_inv_lower_ref,
    trsm_rlt,
    trsm_rlt_ref,
)

#: every kernel wrapper of the port (each has a ``launches`` counter)
KERNELS = (fused_factor_syrk, tri_inv_lower, trsm_rlt, chol_tile, syrk_ln,
           gemm_nt, fused_factor_syrk_guarded)

__all__ = ["KernelBuildError", "fused_factor_syrk", "fused_factor_syrk_ref",
           "fused_factor_syrk_guarded", "fused_factor_syrk_guarded_ref",
           "live_cells",
           "tri_inv_lower",
           "tri_inv_lower_ref", "trsm_rlt", "trsm_rlt_ref", "chol_tile",
           "chol_tile_ref", "potrf_ref", "syrk_ln", "syrk_ln_ref",
           "syrk_ln_sub", "syrk_ln_sub_ref",
           "gemm_nt", "gemm_nt_ref", "KERNELS"]
