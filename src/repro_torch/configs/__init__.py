"""Architecture configs: one module per assigned arch (--arch <id>).
"""

from .base import MLAConfig, ModelConfig, ShapeConfig, SHAPES
from .registry import ARCH_NAMES, REGISTRY, get_config, smoke_variant

__all__ = ["MLAConfig", "ModelConfig", "ShapeConfig", "SHAPES",
           "ARCH_NAMES", "REGISTRY", "get_config", "smoke_variant"]
