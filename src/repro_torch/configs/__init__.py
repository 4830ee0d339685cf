"""Architecture configs of the model zoo (port of ``src/repro/configs``)."""

from repro_torch.configs.base import (
    ARCH_IDS,
    ArchConfig,
    SHAPES,
    ShapeConfig,
    cell_is_supported,
    get_arch,
    input_specs,
)

__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeConfig",
           "cell_is_supported", "get_arch", "input_specs"]
