"""Dense decoder blocks and the unrolled layer stack.

Port of the dense family of ``repro.models.transformer``: pre-norm GQA
attention plus pre-norm MLP, run layer by layer (the reference's unrolled
``decoder_stack`` branch, which is what prefill and decode use). The dense
family has no auxiliary loss, so the functions return no ``aux``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md queue A, "
                f"items 8-9); the port runs the dense family")
        dt = cfg.param_torch_dtype
        self.norm1 = L.RMSNorm(cfg.d_model, dt, device)
        self.attn = L.Attention(cfg, device)
        self.norm2 = L.RMSNorm(cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg, device)


def block_apply(p: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, layer_idx: int, mode: str = "train",
                cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """mode: train | prefill | decode. Returns (x, new_cache)."""
    rs = cfg.residual_scale
    new_cache = dict(cache) if cache is not None else None

    h = L.rmsnorm(p.norm1, x)
    pattern, span = L.layer_attn_pattern(cfg, layer_idx)
    if mode == "decode":
        attn_out, new_cache["attn"] = L.attention_apply(
            p.attn, cfg, h, positions, pattern=pattern, span=span,
            cache=cache["attn"])
    else:
        attn_out, _ = L.attention_apply(p.attn, cfg, h, positions,
                                        pattern=pattern, span=span)
        if mode == "prefill":
            new_cache["attn"] = _write_prefill_cache(cfg, p.attn, h, positions,
                                                     cache["attn"])
    x = x + rs * attn_out
    h2 = L.rmsnorm(p.norm2, x)
    return x + rs * L.mlp_apply(p.mlp, cfg, h2), new_cache


def _write_prefill_cache(cfg, pa: L.Attention, h, positions, cache):
    """Recompute K/V for the tail of the sequence and fill the ring cache
    (recomputed rather than reused, as the reference does)."""
    B, Sq, _ = h.shape
    Lc = cache["k"].shape[1]
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    k = L.linear(pa.wk, h, cdt).reshape(B, Sq, Hkv, hd)
    v = L.linear(pa.wv, h, cdt).reshape(B, Sq, Hkv, hd)
    if cfg.rope_theta > 0:
        k = L.apply_rope(k, positions, theta=cfg.rope_theta,
                         fraction=cfg.rope_fraction)
    take = min(Sq, Lc)
    return L.write_cache(cache, k[:, -take:], v[:, -take:], positions[:, -take:])


def decoder_stack(layers: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str = "train",
                  caches: list | None = None):
    """Run all decoder blocks in order. Returns (x, new_caches)."""
    new_caches = [] if caches is not None else None
    for i, block in enumerate(layers):
        x, nc = block_apply(block, cfg, x, positions, layer_idx=i, mode=mode,
                            cache=caches[i] if caches is not None else None)
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches
