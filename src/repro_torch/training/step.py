"""Serve step construction (port of ``repro.training.step.make_serve_step``).

The training steps of the reference wait for backward kernels (ROADMAP.md
queue A, item 12).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import model as M


def make_serve_step(cfg: ModelConfig):
    """(params, tokens (B,1), pos (B,), caches) -> (next_tokens, new_caches)."""

    def serve_step(params, tokens, pos, caches):
        logits, caches = M.decode_step(params, cfg, tokens, pos, caches)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, caches

    return serve_step
