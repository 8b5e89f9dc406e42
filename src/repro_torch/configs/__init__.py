from .base import ArchConfig, ShapeConfig, SHAPES, get_shape, shape_applicable
from .registry import ARCH_IDS, get_config
