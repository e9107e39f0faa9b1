from .base import (  # noqa: F401
    ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES, ArchConfig, ShapeCell,
    TrainSettings, cells_for, get_config, get_reduced,
)
