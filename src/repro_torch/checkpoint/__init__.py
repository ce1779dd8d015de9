"""Fault-tolerant checkpointing: atomic, async."""
from .checkpointer import Checkpointer, latest_step, restore, save

__all__ = ["Checkpointer", "latest_step", "restore", "save"]
