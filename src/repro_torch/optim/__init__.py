"""Optimizers and schedules."""
from .adamw import AdamWConfig, AdamWState, adamw_update, global_norm, init_adamw, lr_schedule

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_update",
    "global_norm",
    "init_adamw",
    "lr_schedule",
]
