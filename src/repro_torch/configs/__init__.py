from repro_torch.configs.registry import (
    ARCHS,
    SHAPES,
    get_config,
    get_smoke_config,
    cell_supported,
    input_specs,
)

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke_config",
           "cell_supported", "input_specs"]
