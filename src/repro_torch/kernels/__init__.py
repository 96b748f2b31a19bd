"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it in the same module:

    fused  — batched POTRF + TRSM + SYRK over a (level x bucket) group
             (replaces src/repro/kernels/fused.py::fused_factor_syrk)
    trsm   — batched lower-triangular inverse of the diagonal blocks
             (replaces src/repro/kernels/trsm.py::trsm_rlt on the solve path)

A wrapper runs the plain version for a CPU tensor and launches its kernel,
or raises, for a CUDA tensor.  ``_build`` compiles ``csrc/*.cu`` at first
use.
"""
from repro_torch.kernels.fused import fused_factor_syrk, fused_factor_syrk_ref
from repro_torch.kernels.trsm import tri_inv_lower, tri_inv_lower_ref

__all__ = ["fused_factor_syrk", "fused_factor_syrk_ref", "tri_inv_lower",
           "tri_inv_lower_ref"]
