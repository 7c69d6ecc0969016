"""Assigned architecture configs (one module per arch) + shape cells."""

from .base import (ARCH_IDS, SHAPES, ArchConfig, all_configs,  # noqa: F401
                   get_config, get_smoke_config, register)
