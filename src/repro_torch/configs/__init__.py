from repro_torch.configs.archs import ALIASES, ARCHS, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced, shape_cells

__all__ = [
    "ALIASES",
    "ARCHS",
    "get_config",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "reduced",
    "shape_cells",
]
