"""Gradient compression (int8 + error feedback), port of ``repro.optim.compress``.

``compress_leaf``/``decompress_leaf`` quantize one tensor to int8 with one
scale; ``ef_step`` wraps a gradient tree with error feedback (the residual
carried beside the optimizer state), so the quantization error is
re-injected on the next step (the 1-bit Adam / EF-SGD lineage). The
cross-device reduce it is meant for waits for multi-device training; the
CPU tests check the numbers and the convergence.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def compress_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    return pytree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def ef_step(grads, ef_state):
    """Returns (decompressed grads actually applied, new ef_state)."""

    def leaf(g, e):
        corrected = g.float() + e
        q, s = compress_leaf(corrected)
        dq = decompress_leaf(q, s)
        return dq.to(g.dtype), corrected - dq

    flat_g, spec = pytree.tree_flatten(grads)
    flat_e, espec = pytree.tree_flatten(ef_state)
    if espec != spec:
        raise ValueError(f"error-feedback state {espec} does not match the grads' {spec}")
    out = [leaf(g, e) for g, e in zip(flat_g, flat_e)]
    return (pytree.tree_unflatten([o[0] for o in out], spec),
            pytree.tree_unflatten([o[1] for o in out], spec))
