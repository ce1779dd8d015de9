"""Architecture configs of the port: one module per architecture ported so
far (the four dense ones; the rest wait, ROADMAP.md Queue 1 item 11).

``get_config("<arch-id>")`` returns the exact published configuration;
``get_config("<arch-id>", reduced=True)`` returns a small same-family config
for CPU smoke tests.
"""
from .base import (
    SHAPES,
    ModelConfig,
    ShapeCell,
    get_config,
    list_archs,
    register,
    runnable_cells,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeCell",
    "get_config",
    "list_archs",
    "register",
    "runnable_cells",
]
