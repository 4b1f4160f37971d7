"""Port of ``repro/configs``: every architecture configuration of the
reference as plain data (``base.py`` and one module per architecture)."""
from repro_torch.configs.base import (
    ALL_SHAPES,
    ARCH_IDS,
    SHAPES_BY_NAME,
    ArchConfig,
    MoEConfig,
    ShapeSpec,
    all_configs,
    get_config,
)

__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "SHAPES_BY_NAME",
    "ArchConfig",
    "MoEConfig",
    "ShapeSpec",
    "all_configs",
    "get_config",
]
