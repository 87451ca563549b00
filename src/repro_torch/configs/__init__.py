"""Architecture configs: one module per assigned arch + the paper's own."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_supported,
    get_config,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "cell_supported",
    "get_config",
]
