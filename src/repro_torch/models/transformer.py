"""Decoder and encoder blocks and the unrolled layer stacks.

Port of ``repro.models.transformer`` for every family of the reference:

* dense / vlm: pre-norm GQA attention + pre-norm MLP (vlm, Chameleon, is
  dense with qk-norm);
* moe:    pre-norm GQA attention + pre-norm MoE;
* ssm:    pre-norm Mamba-2 mixer (no MLP: a pure Mamba-2 stack);
* hybrid: pre-norm attention ∥ SSM on the same normed input, fused as the
  mean of the two outputs' RMSNorms, + pre-norm MLP (Hymba); or, with
  ``layer_types``, a pre-norm mixer chosen by the layer's kind (Mamba-2 or
  attention), each + pre-norm MoE (Granite 4.0-H);
* encdec: LayerNorm blocks; the decoder's blocks add cross-attention to
  the encoder's output (from the cached K/V in decode), and the encoder's
  blocks are bidirectional with no RoPE (Whisper).

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


def norm_module(cfg: ModelConfig, d: int, device=None) -> nn.Module:
    """LayerNorm for encdec, RMSNorm for every other family."""
    cls = L.LayerNorm if cfg.family == "encdec" else L.RMSNorm
    return cls(d, cfg.param_torch_dtype, device)


def norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return L.layernorm(p, x) if cfg.family == "encdec" else L.rmsnorm(p, x)


class Block(nn.Module):
    """Decoder block ``layer``: its mixer by ``cfg.layer_kind(layer)``."""

    def __init__(self, cfg: ModelConfig, device=None, layer: int = 0):
        super().__init__()
        dt = cfg.param_torch_dtype
        self.norm1 = norm_module(cfg, cfg.d_model, device)
        if cfg.layer_kind(layer) == "mamba":
            self.ssm = S.SSM(cfg, device)
            if cfg.family == "ssm":
                return
        else:
            self.attn = L.Attention(cfg, device)
        if cfg.hybrid_ssm:
            self.ssm = S.SSM(cfg, device)
            self.attn_out_norm = L.RMSNorm(cfg.d_model, dt, device)
            self.ssm_out_norm = L.RMSNorm(cfg.d_model, dt, device)
        self.norm2 = norm_module(cfg, cfg.d_model, device)
        if cfg.num_experts:
            self.moe = M.MoE(cfg, device)
        else:
            self.mlp = L.MLP(cfg, device)
        if cfg.family == "encdec":
            self.cross_norm = norm_module(cfg, cfg.d_model, device)
            self.cross = L.Attention(cfg, device, cross=True)


def block_apply(p: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, layer_idx: int, mode: str = "train",
                cache: dict | None = None, enc_out: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """mode: train | prefill | decode. Returns (x, aux, new_cache)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    rs = cfg.residual_scale
    new_cache = dict(cache) if cache is not None else None

    h = norm(cfg, p.norm1, x)
    if cfg.layer_kind(layer_idx) == "mamba":
        y, st = S.ssm_apply(p.ssm, cfg, h, state=cache["ssm"] if cache else None)
        if new_cache is not None:
            new_cache["ssm"] = st
        x = x + rs * y
        if cfg.family == "ssm":
            return x, aux, new_cache
    else:
        x = _attention_mixer(p, cfg, x, h, positions, layer_idx=layer_idx, mode=mode,
                             cache=cache, new_cache=new_cache, enc_out=enc_out)

    h2 = norm(cfg, p.norm2, x)
    if cfg.num_experts:
        mlp_out, aux = M.moe_apply(p.moe, cfg, h2)
    else:
        mlp_out = L.mlp_apply(p.mlp, cfg, h2)
    return x + rs * mlp_out, aux, new_cache


def _attention_mixer(p: Block, cfg: ModelConfig, x, h, positions, *, layer_idx: int,
                     mode: str, cache, new_cache, enc_out):
    """Attention (∥ the SSM when hybrid) and, for encdec, cross-attention:
    the residual stream after them; ``new_cache`` is filled in place."""
    rs = cfg.residual_scale
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

    if cfg.hybrid_ssm:
        ssm_out, st = S.ssm_apply(p.ssm, cfg, h, state=cache["ssm"] if cache else None)
        if new_cache is not None and mode != "train":
            new_cache["ssm"] = st
        fused = 0.5 * (L.rmsnorm(p.attn_out_norm, attn_out)
                       + L.rmsnorm(p.ssm_out_norm, ssm_out))
        x = x + rs * fused
    else:
        x = x + rs * attn_out

    if cfg.family == "encdec" and (
            enc_out is not None or (cache is not None and "cross_kv" in cache)):
        hc = norm(cfg, p.cross_norm, x)
        if mode == "decode" and cache is not None and "cross_kv" in cache:
            c_out = _cross_from_cache(p.cross, cfg, hc, cache["cross_kv"])
        else:
            kv_pos = torch.zeros(enc_out.shape[:2], dtype=torch.int32, device=x.device)
            c_out, _ = L.attention_apply(p.cross, cfg, hc, positions, causal=False,
                                         kv_x=enc_out, kv_positions=kv_pos, use_rope=False)
            if new_cache is not None:
                new_cache["cross_kv"] = _make_cross_cache(p.cross, cfg, enc_out)
        x = x + rs * c_out
    return x


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


def _make_cross_cache(pa: L.Attention, cfg: ModelConfig, enc_out: torch.Tensor) -> dict:
    """The cross-attention's K and V of the encoder output, computed once at
    prefill and read by every decode step."""
    B, Se, _ = enc_out.shape
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    return {"k": L.linear(pa.wk, enc_out, cdt).reshape(B, Se, Hkv, hd),
            "v": L.linear(pa.wv, enc_out, cdt).reshape(B, Se, Hkv, hd)}


def _cross_from_cache(pa: L.Attention, cfg: ModelConfig, h: torch.Tensor, kv: dict):
    """Cross-attention of the decode step's queries against the cached K/V:
    plain products in f32, as in the reference (no kernel)."""
    B, Sq, _ = h.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    q = L.linear(pa.wq, h, cdt).reshape(B, Sq, H, hd)
    group = H // Hkv
    kf = torch.repeat_interleave(kv["k"], group, dim=2)
    vf = torch.repeat_interleave(kv["v"], group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * (hd ** -0.5)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf.float()).to(cdt)
    return L.linear(pa.wo, out.reshape(B, Sq, H * hd), cdt)


class EncoderBlock(nn.Module):
    """Whisper's encoder block: bidirectional attention, no RoPE, MLP."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = norm_module(cfg, cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.norm2 = norm_module(cfg, cfg.d_model, device)
        self.mlp = L.MLP(cfg, device)


def encoder_block_apply(p: EncoderBlock, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    h = norm(cfg, p.norm1, x)
    a, _ = L.attention_apply(p.attn, cfg, h, positions, causal=False, use_rope=False)
    x = x + a
    return x + L.mlp_apply(p.mlp, cfg, norm(cfg, p.norm2, x))


def encoder_stack(layers, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """All encoder blocks in order (unrolled)."""
    B, Se, _ = x.shape
    positions = torch.arange(Se, dtype=torch.int32, device=x.device)[None].expand(B, Se)
    for block in layers:
        x = encoder_block_apply(block, cfg, x, positions)
    return x


def decoder_stack(layers: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str = "train",
                  caches: list | None = None, enc_out: torch.Tensor | None = None):
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
                                  mode=mode, enc_out=enc_out, use_reentrant=False,
                                  preserve_rng_state=False)
            aux = aux + a
            continue
        x, a, nc = block_apply(block, cfg, x, positions, layer_idx=i, mode=mode,
                               cache=caches[i] if caches is not None else None,
                               enc_out=enc_out)
        aux = aux + a
        if new_caches is not None:
            new_caches.append(nc)
    return x, aux, new_caches
