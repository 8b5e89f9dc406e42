from .base import ArchConfig
from .registry import ARCH_IDS, get_config
