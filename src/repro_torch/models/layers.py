"""Building blocks: ``nn.Module`` parameter holders and plain apply functions.

Port of the subset of ``repro.models.layers`` that the ported decoders
run: GQA attention with optional qk-norm (qwen3-moe) and the swiglu MLP;
the gelu/relu² MLPs come with the configs that use them. Each module
holds the parameters the reference keeps in a pytree dict, under the same
names (``Linear.w`` is ``(d_in, d_out)`` as in JAX, so ``y = x @ w``);
each ``*_apply`` / ``linear`` / ``rmsnorm`` is a plain function of a
module and tensors, so it runs as well on a view of the same names over
plain tensors (``model.bind``), which is how training differentiates them.
A module's own parameters are made with ``requires_grad=False`` (serving
never wants their gradients); training takes them as a name -> tensor dict
(``model.params_of``) and asks for gradients of that. Compute dtype is
``cfg.dtype``, params ``cfg.param_dtype``, with f32 softmax and norms.

The KV cache is updated out of place (``scatter``), never in place, so the
decode step can be ``torch.func.vmap``-ed across tenants.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops


def _param(*shape, dtype, device, fill: float | None = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def init_dense_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Truncated normal on [-2, 2] std, std = fan_in^-1/2 (the reference's rule)."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


# ---------------------------------------------------------------------------
# Linear / norm / embedding
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = _param(d_in, d_out, dtype=dtype, device=device)
        self.b = _param(d_out, dtype=dtype, device=device, fill=0.0) if bias else None

    def init_(self, generator: torch.Generator) -> None:
        init_dense_(self.w, self.w.shape[0], generator)


def linear(p: Linear, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in the compute dtype, then the bias added in f32, then cast.

    The reference keeps the product in f32 (``preferred_element_type``)
    before the bias; a bf16 ``matmul`` here accumulates in f32 but rounds its
    result to bf16 first, one rounding more. In f32 the two are the same.
    """
    y = torch.matmul(x.to(compute_dtype), p.w.to(compute_dtype))
    if p.b is not None:
        y = y.float() + p.b.float()
    return y.to(compute_dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = _param(d, dtype=dtype, device=device, fill=1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x, p.scale, eps=eps)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.table = _param(vocab, d, dtype=dtype, device=device)

    def init_(self, generator: torch.Generator) -> None:
        init_dense_(self.table, self.table.shape[1], generator)


def embed(p: Embedding, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.embedding(tokens, p.table).to(compute_dtype)


def unembed(p: Embedding, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Logits in f32 (softmax stability)."""
    return torch.matmul(x.to(compute_dtype), p.table.to(compute_dtype).t()).float()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates halves (not
    interleaved pairs) of the first ``fraction`` of head dims, angles in f32."""
    D = x.shape[-1]
    rot = int(D * fraction) // 2 * 2
    if rot == 0 or theta <= 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    # made on the device: a host tensor copied in would sync a captured step
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., None].float() * freqs                # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA; full / sliding / chunked; optional KV cache)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = cfg.param_torch_dtype
        self.wq = Linear(d, H * hd, bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wk = Linear(d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wv = Linear(d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wo = Linear(H * hd, d, dtype=dt, device=device)
        self.qnorm = RMSNorm(hd, dt, device) if cfg.qk_norm else None
        self.knorm = RMSNorm(hd, dt, device) if cfg.qk_norm else None


def layer_attn_pattern(cfg: ModelConfig, layer_idx: int) -> tuple[str, int]:
    """(pattern, span) for a layer: 'full' | ('sliding', w) | ('chunked', c)."""
    if cfg.attention == "sliding" and cfg.window:
        return "sliding", cfg.window
    if cfg.attention == "chunked" and cfg.attn_chunk:
        k = cfg.global_attn_every
        if k and (layer_idx + 1) % k == 0:
            return "full", 0       # iRoPE: every k-th layer is global
        return "chunked", cfg.attn_chunk
    return "full", 0


def attention_apply(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, pattern: str = "full",
                    span: int = 0, causal: bool = True,
                    cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype

    q = linear(p.wq, x, cdt).reshape(B, S, H, hd)
    k = linear(p.wk, x, cdt).reshape(B, S, Hkv, hd)
    v = linear(p.wv, x, cdt).reshape(B, S, Hkv, hd)
    if p.qnorm is not None:
        q = rmsnorm(p.qnorm, q)
        k = rmsnorm(p.knorm, k)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)

    if cache is not None:
        out, cache = _cached_attention(cfg, q, k, v, positions, cache,
                                       pattern=pattern, span=span)
    else:
        out = ops.attention(q, k, v, causal=causal,
                            window=span if pattern == "sliding" else None,
                            chunk=span if pattern == "chunked" else None)
    return linear(p.wo, out.reshape(B, S, H * hd), cdt), cache


def cache_len_for(cfg: ModelConfig, layer_idx: int, max_len: int) -> int:
    pattern, span = layer_attn_pattern(cfg, layer_idx)
    if pattern in ("sliding", "chunked") and span:
        return min(max_len, span)
    return max_len


def init_attn_cache(cfg: ModelConfig, layer_idx: int, batch: int, max_len: int,
                    device=None) -> dict:
    L = cache_len_for(cfg, layer_idx, max_len)
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    return {
        "k": torch.zeros((batch, L, Hkv, hd), dtype=cdt, device=device),
        "v": torch.zeros((batch, L, Hkv, hd), dtype=cdt, device=device),
        "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
    }


def write_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor) -> dict:
    """Out-of-place ``cache[b, pos % L] = (k, v, pos)`` (the reference's
    ``.at[bidx, slots].set``), in a form ``torch.func.vmap`` batches."""
    B, S, Hkv, hd = k.shape
    slots = (positions % cache["k"].shape[1]).long()           # (B, S)
    idx = slots[:, :, None, None].expand(B, S, Hkv, hd)
    return {"k": cache["k"].scatter(1, idx, k),
            "v": cache["v"].scatter(1, idx, v),
            "pos": cache["pos"].scatter(1, slots, positions.to(cache["pos"].dtype))}


def _cached_attention(cfg, q, k_new, v_new, positions, cache, *,
                      pattern: str, span: int):
    """Decode/step attention against a (ring-buffered) KV cache.

    Slots are addressed ``pos % cache_len``; keys are cached post-RoPE and
    masking uses per-slot absolute positions, as in the reference.
    """
    Hkv, hd = k_new.shape[2], k_new.shape[3]
    new_cache = write_cache(cache, k_new, v_new, positions)
    ck, cv, cpos = new_cache["k"], new_cache["v"], new_cache["pos"]

    group = cfg.num_heads // Hkv
    qg = q.reshape(q.shape[0], q.shape[1], Hkv, group, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * (hd ** -0.5)
    qpos = positions[:, :, None]                            # (B, S, 1)
    kpos = cpos[:, None, :]                                 # (B, 1, L)
    mask = (kpos >= 0) & (kpos <= qpos)                     # filled & causal
    if pattern == "sliding" and span:
        mask &= (qpos - kpos) < span
    if pattern == "chunked" and span:
        mask &= torch.div(qpos, span, rounding_mode="floor") == \
            torch.div(kpos, span, rounding_mode="floor")
    s = torch.where(mask[:, None, None], s, -1e30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                       cv.float()).to(q.dtype)
    return out.reshape(q.shape), new_cache


# ---------------------------------------------------------------------------
# MLP (swiglu)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, d_ff: int | None = None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.param_torch_dtype
        self.up = Linear(d, f, dtype=dt, device=device)
        self.down = Linear(f, d, dtype=dt, device=device)
        self.gate = Linear(d, f, dtype=dt, device=device)


def mlp_apply(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cdt = cfg.compute_dtype
    up = linear(p.up, x, cdt)
    act = F.silu(linear(p.gate, x, cdt).float())
    return linear(p.down, (act * up.float()).to(cdt), cdt)
