"""Decoder blocks and the unrolled layer stack.

Port of ``repro.models.transformer`` for the ported families:

* dense: pre-norm GQA attention + pre-norm MLP;
* moe:   pre-norm GQA attention + pre-norm MoE;
* ssm:   pre-norm Mamba-2 mixer (no MLP: a pure Mamba-2 stack).

Blocks run layer by layer (the reference's unrolled ``decoder_stack``
branch, which is what prefill and decode use) and return the MoE auxiliary
loss beside the activations, summed over layers as the reference does. In
training (``mode="train"`` with gradients on), ``cfg.remat`` other than
``"none"`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` does (under the kernel mode of the forward, which
autograd's own thread would not see); ``"dots"`` (the reference's policy that keeps
non-batched products) has no selective policy here and recomputes the
whole block as ``"full"`` does.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import registry as _kreg
from . import layers as L
from . import moe as M
from . import ssm as S

PORTED_FAMILIES = ("dense", "moe", "ssm")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES or cfg.hybrid_ssm:
            raise NotImplementedError(
                f"family {cfg.family!r} (hybrid_ssm={cfg.hybrid_ssm}) is not ported "
                f"yet: hybrid, encdec and vlm wait for later slices (ROADMAP.md "
                f"queue A)")
        dt = cfg.param_torch_dtype
        self.norm1 = L.RMSNorm(cfg.d_model, dt, device)
        if cfg.family == "ssm":
            self.ssm = S.SSM(cfg, device)
            return
        self.attn = L.Attention(cfg, device)
        self.norm2 = L.RMSNorm(cfg.d_model, dt, device)
        if cfg.num_experts:
            self.moe = M.MoE(cfg, device)
        else:
            self.mlp = L.MLP(cfg, device)


def block_apply(p: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, layer_idx: int, mode: str = "train",
                cache: dict | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """mode: train | prefill | decode. Returns (x, aux, new_cache)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    rs = cfg.residual_scale
    new_cache = dict(cache) if cache is not None else None

    h = L.rmsnorm(p.norm1, x)
    if cfg.family == "ssm":
        y, st = S.ssm_apply(p.ssm, cfg, h, state=cache["ssm"] if cache else None)
        if new_cache is not None:
            new_cache["ssm"] = st
        return x + rs * y, aux, new_cache

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
    if cfg.num_experts:
        mlp_out, aux = M.moe_apply(p.moe, cfg, h2)
    else:
        mlp_out = L.mlp_apply(p.mlp, cfg, h2)
    return x + rs * mlp_out, aux, new_cache


def _write_prefill_cache(cfg, pa: L.Attention, h, positions, cache):
    """Recompute K/V for the tail of the sequence and fill the ring cache
    (recomputed rather than reused, as the reference does)."""
    B, Sq, _ = h.shape
    Lc = cache["k"].shape[1]
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    k = L.linear(pa.wk, h, cdt).reshape(B, Sq, Hkv, hd)
    v = L.linear(pa.wv, h, cdt).reshape(B, Sq, Hkv, hd)
    if pa.knorm is not None:
        k = L.rmsnorm(pa.knorm, k)
    if cfg.rope_theta > 0:
        k = L.apply_rope(k, positions, theta=cfg.rope_theta,
                         fraction=cfg.rope_fraction)
    take = min(Sq, Lc)
    return L.write_cache(cache, k[:, -take:], v[:, -take:], positions[:, -take:])


def decoder_stack(layers: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str = "train",
                  caches: list | None = None):
    """Run all decoder blocks in order. Returns (x, total_aux, new_caches)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    remat = cfg.remat != "none" and mode == "train" and torch.is_grad_enabled()
    kernel_mode = _kreg.kernel_mode()

    def recomputable(*args, **kwargs):
        # the recompute runs on autograd's thread: pin this thread's kernel mode
        with _kreg.kernel_mode_scope(kernel_mode):
            return block_apply(*args, **kwargs)

    for i, block in enumerate(layers):
        if remat:
            x, a, nc = checkpoint(recomputable, block, cfg, x, positions, layer_idx=i,
                                  mode=mode, use_reentrant=False,
                                  preserve_rng_state=False)
            aux = aux + a
            continue
        x, a, nc = block_apply(block, cfg, x, positions, layer_idx=i, mode=mode,
                               cache=caches[i] if caches is not None else None)
        aux = aux + a
        if new_caches is not None:
            new_caches.append(nc)
    return x, aux, new_caches
