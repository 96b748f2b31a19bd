"""repro_torch.core — the supernodal Cholesky of ``src/repro/core`` (the
device-resident level-scheduled path, the paper's sequential RL/RLB offload
paths, the mixed host/device levels path, the breakdown guard, the plan
cache and multi-matrix factorization), ported to PyTorch with hand-written
CUDA kernels.  Imports neither JAX nor the reference package."""
from repro_torch.core import counters
from repro_torch.core.api import (
    cholesky,
    cholesky_many,
    solve,
    symbolic_pipeline,
)
from repro_torch.core.buckets import (
    bucket_shape,
    bucket_shape_batch,
    bucket_shape_fused,
    syrk_tile,
)
from repro_torch.core.convert import (
    cached_plan_from_arrays,
    storage_from_array,
    symbolic_from_arrays,
)
from repro_torch.core.device_store import (
    DeviceGroupPlan,
    DevicePanelStore,
    GroupIndices,
    build_device_plan,
    device_plan,
    device_solve,
)
from repro_torch.core.engines import DeviceEngine, resolve_device
from repro_torch.core.guard import (
    BadMatrixError,
    BreakdownError,
    GuardReport,
    perturb_threshold,
    validate_matrix,
)
from repro_torch.core.merge import merge_supernodes
from repro_torch.core.numeric import (
    BatchCholeskyFactor,
    CholeskyFactor,
    HostEngine,
    OffloadPolicy,
    PanelStore,
    factorize_levels,
    factorize_levels_device_many,
    factorize_rl,
    factorize_rlb,
    init_panel_store,
    init_panels,
)
from repro_torch.core.plan_cache import (
    CachedPlan,
    PlanCache,
    build_fill_plan,
    canonical_csc,
    pattern_fingerprint,
)
from repro_torch.core.refine import refine_partition, refine_solve
from repro_torch.core.relind import (
    ancestor_updates,
    build_scatter_plan,
    count_blas_calls,
    count_blocks,
    scatter_plan,
    supernode_blocks,
)
from repro_torch.core.schedule import (
    LevelSchedule,
    build_schedule,
    cached_schedule,
    group_flop_stats,
    level_sets,
    supernode_levels,
)
from repro_torch.core.symbolic import (
    SymbolicFactor,
    col_counts,
    etree,
    find_supernodes,
    postorder,
    symbolic_analyze,
)

__all__ = [
    "counters", "cholesky", "cholesky_many", "solve", "symbolic_pipeline",
    "bucket_shape", "bucket_shape_batch", "bucket_shape_fused", "syrk_tile",
    "cached_plan_from_arrays", "storage_from_array", "symbolic_from_arrays",
    "DeviceGroupPlan", "DevicePanelStore", "GroupIndices",
    "build_device_plan", "device_plan", "device_solve",
    "DeviceEngine", "resolve_device",
    "BadMatrixError", "BreakdownError", "GuardReport", "perturb_threshold",
    "validate_matrix", "merge_supernodes",
    "BatchCholeskyFactor", "CholeskyFactor", "HostEngine", "OffloadPolicy",
    "PanelStore", "factorize_levels", "factorize_levels_device_many",
    "factorize_rl", "factorize_rlb", "init_panel_store", "init_panels",
    "CachedPlan", "PlanCache", "build_fill_plan", "canonical_csc",
    "pattern_fingerprint",
    "refine_partition", "refine_solve", "ancestor_updates",
    "build_scatter_plan", "count_blas_calls", "count_blocks", "scatter_plan",
    "supernode_blocks",
    "LevelSchedule", "build_schedule", "cached_schedule", "group_flop_stats",
    "level_sets", "supernode_levels",
    "SymbolicFactor", "col_counts", "etree", "find_supernodes", "postorder",
    "symbolic_analyze",
]
