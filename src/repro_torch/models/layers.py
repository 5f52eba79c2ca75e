"""Building blocks: ``nn.Module`` parameter holders and plain apply functions.

Port of ``repro.models.layers``: linear, RMSNorm and LayerNorm, embeddings,
sinusoidal positions, RoPE, GQA attention (self or cross, optional qk-norm)
and the swiglu / gelu / relu² MLPs. Each module
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


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = _param(d, dtype=dtype, device=device, fill=1.0)
        self.bias = _param(d, dtype=dtype, device=device, fill=0.0)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm in f32 (the reference's is plain jnp, no kernel)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


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


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., S) int positions -> (..., S, d) f32 sinusoids: sin of the first
    d / 2 frequencies, then cos. Made on the positions' device (a captured
    decode step copies nothing in from the host)."""
    pos = positions.float()[..., None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    base = torch.full((), 10000.0, dtype=torch.float32, device=positions.device)
    ang = pos / torch.pow(base, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) sinusoids of positions 0..seq-1 (the encoder's)."""
    return sinusoidal_at(torch.arange(seq, device=device), d)


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
    """``cross=True``: the decoder's cross-attention, which has no qk-norm."""

    def __init__(self, cfg: ModelConfig, device=None, cross: bool = False):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = cfg.param_torch_dtype
        self.wq = Linear(d, H * hd, bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wk = Linear(d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wv = Linear(d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wo = Linear(H * hd, d, dtype=dt, device=device)
        qk_norm = cfg.qk_norm and not cross
        self.qnorm = RMSNorm(hd, dt, device) if qk_norm else None
        self.knorm = RMSNorm(hd, dt, device) if qk_norm else None


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
                    kv_x: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    cache: dict | None = None,
                    use_rope: bool = True) -> tuple[torch.Tensor, dict | None]:
    """Self-attention over ``x``, or cross-attention from ``kv_x`` (never
    causal: the reference passes ``causal and kv_x is None``)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype

    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = linear(p.wq, x, cdt).reshape(B, S, H, hd)
    k = linear(p.wk, src, cdt).reshape(B, Skv, Hkv, hd)
    v = linear(p.wv, src, cdt).reshape(B, Skv, Hkv, hd)
    if p.qnorm is not None:
        q = rmsnorm(p.qnorm, q)
        k = rmsnorm(p.knorm, k)
    if use_rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        kpos = positions if kv_positions is None else kv_positions
        k = apply_rope(k, kpos, theta=cfg.rope_theta, fraction=cfg.rope_fraction)

    if cache is not None:
        out, cache = _cached_attention(cfg, q, k, v, positions, cache,
                                       pattern=pattern, span=span)
    else:
        out = ops.attention(q, k, v, causal=causal and kv_x is None,
                            window=span if pattern == "sliding" else None,
                            chunk=span if pattern == "chunked" else None,
                            scale=cfg.attn_scale or None, q_chunk=cfg.attn_q_chunk)
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
    masking uses per-slot absolute positions, as in the reference. Scores
    are scaled by ``cfg.attn_scale``, else head_dim ** -0.5.
    """
    Hkv, hd = k_new.shape[2], k_new.shape[3]
    new_cache = write_cache(cache, k_new, v_new, positions)
    ck, cv, cpos = new_cache["k"], new_cache["v"], new_cache["pos"]

    group = cfg.num_heads // Hkv
    qg = q.reshape(q.shape[0], q.shape[1], Hkv, group, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * (cfg.attn_scale or hd ** -0.5)
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
# MLP (swiglu / gelu / relu^2)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``up`` and ``down``; swiglu alone has a ``gate``."""

    def __init__(self, cfg: ModelConfig, device=None, d_ff: int | None = None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.param_torch_dtype
        self.up = Linear(d, f, dtype=dt, device=device)
        self.down = Linear(f, d, dtype=dt, device=device)
        self.gate = Linear(d, f, dtype=dt, device=device) if cfg.mlp == "swiglu" else None


def mlp_apply(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The activation in f32. gelu is the tanh approximation, which is what
    ``jax.nn.gelu`` computes by default."""
    cdt = cfg.compute_dtype
    up = linear(p.up, x, cdt).float()
    if cfg.mlp == "swiglu":
        h = F.silu(linear(p.gate, x, cdt).float()) * up
    elif cfg.mlp == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:  # relu2 (Nemotron)
        h = torch.relu(up) ** 2
    return linear(p.down, h.to(cdt), cdt)
