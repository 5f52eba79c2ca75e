"""Plain float32 forward of a dense pre-norm decoder (GLM-4, Minitron).

The frozen reference that decides ``correct``: plain ``torch`` operations,
no kernels, no cache, no batching, TF32 off. It reads the benchmark's own
weight dict (keys as :func:`portbench.weights.layout` names them) and the
configuration's ``model`` block, and imports nothing of the program.

The decoder, per layer: ``x += attn(rmsnorm(x))`` and ``x += mlp(rmsnorm(x))``;
attention is causal GQA with RoPE rotating the two halves of the first
``rope_fraction`` of each head's dims, QKV bias where ``qkv_bias``; the MLP is
SwiGLU (``silu(x Wg) * (x Wu) Wd``) or squared ReLU (``relu(x Wu)^2 Wd``); a
final RMSNorm and an untied head. Logits cover the real vocabulary only.

``quant="fp8"`` is the control: every linear layer's input rows and weight
columns rounded to float8 e4m3 (each row or column scaled to the format's
448 first), the products then taken in float32: the W8A8 step a lower
precision than the configuration's bfloat16 would take.
"""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Full float32 products inside the block; the previous settings after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, quant: str | None):
    w = w.float()
    if quant == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    y = x @ w
    return y if b is None else y + b.float()


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float):
    """x (S, H, D): rotate the halves of the first ``fraction`` of D."""
    rot = int(x.shape[-1] * fraction) // 2 * 2
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = positions.double()[:, None] * freqs                      # (S, half)
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)


def _attention(q, k, v, block: int) -> torch.Tensor:
    """Causal GQA over (S, H, D) / (S, Hkv, D), query rows in blocks."""
    S, H, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)           # (H, S, D)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = torch.einsum("qhd,hkd->hqk", q[lo:hi], k[:, :hi]) / math.sqrt(D)
        keep = kpos[None, :hi] <= torch.arange(lo, hi, device=q.device)[:, None]
        s = s.masked_fill(~keep[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1), v[:, :hi])
    return out


@torch.no_grad()
def logits_at(model: dict, weights: dict, tokens: torch.Tensor, rows: torch.Tensor,
              quant: str | None = None, block: int = 1024) -> torch.Tensor:
    """Logits (len(rows), vocab_size) in float32 of one sequence ``tokens`` (S,)
    at positions ``rows``: the full forward over all S positions, the head on
    the rows asked for."""
    with no_tf32():
        S = tokens.shape[0]
        H, Hkv = model["num_heads"], model["num_kv_heads"]
        hd = model.get("head_dim") or model["d_model"] // H
        eps = model["norm_eps"]
        pos = torch.arange(S, device=tokens.device)
        x = weights["embed.table"][tokens.long()].float()
        for i in range(model["num_layers"]):
            p = f"layers.{i}."
            h = _rmsnorm(x, weights[p + "norm1.scale"], eps)
            q = _linear(h, weights[p + "attn.wq.w"], weights.get(p + "attn.wq.b"), quant)
            k = _linear(h, weights[p + "attn.wk.w"], weights.get(p + "attn.wk.b"), quant)
            v = _linear(h, weights[p + "attn.wv.w"], weights.get(p + "attn.wv.b"), quant)
            q = _rope(q.view(S, H, hd), pos, model["rope_theta"], model["rope_fraction"])
            k = _rope(k.view(S, Hkv, hd), pos, model["rope_theta"], model["rope_fraction"])
            a = _attention(q, k, v.view(S, Hkv, hd), block).reshape(S, H * hd)
            x = x + _linear(a, weights[p + "attn.wo.w"], None, quant)
            h = _rmsnorm(x, weights[p + "norm2.scale"], eps)
            up = _linear(h, weights[p + "mlp.up.w"], None, quant)
            if model["mlp"] == "swiglu":
                act = torch.nn.functional.silu(
                    _linear(h, weights[p + "mlp.gate.w"], None, quant)) * up
            elif model["mlp"] == "relu2":
                act = torch.relu(up) ** 2
            else:
                raise ValueError(f"no reference for mlp {model['mlp']!r}")
            x = x + _linear(act, weights[p + "mlp.down.w"], None, quant)
        h = _rmsnorm(x[rows], weights["final_norm.scale"], eps)
        head = weights["head.table"][: model["vocab_size"]]
        return _linear(h, head.t(), None, quant)
