"""repro_torch — the PyTorch/CUDA port of ``repro``'s sparse Cholesky for
one NVIDIA H100.  ``src/repro/`` stays the reference; this package mirrors
its layout (``sparse/``, ``core/``, ``kernels/``), imports neither JAX nor
``repro``, and runs its entry points on ``cuda`` unless the caller passes
``device="cpu"``."""
