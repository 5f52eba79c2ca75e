"""Optimizers, schedules, gradient compression (port of ``repro.optim``)."""
from . import compress, schedule
from .adamw import Optimizer, adamw, apply_updates, clip_by_global_norm, global_norm
from .schedule import warmup_cosine, wsd

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "global_norm", "warmup_cosine", "wsd", "schedule", "compress"]
