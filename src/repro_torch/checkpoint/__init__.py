"""Checkpointing: async, restartable, in the reference's on-disk layout."""
from .checkpointer import Checkpointer, latest_step, load_pytree, save_pytree

__all__ = ["Checkpointer", "latest_step", "save_pytree", "load_pytree"]
