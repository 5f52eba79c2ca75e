"""Plain PyTorch versions of the ported kernels (port of ``repro.kernels.ref``).

These are the numerical ground truth beside each CUDA kernel: the CPU
tests run them against the reference's JAX oracles, and ``chip_smoke.py``
holds each kernel against them on the card. CPU tensors take them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,        # sliding window size (keys kept per query)
    chunk: int | None = None,         # chunked-local attention
    scale: float | None = None,
    q_offset: int = 0,                # absolute position of q[0] (decode steps)
) -> torch.Tensor:
    """Reference scaled-dot-product attention with GQA broadcast."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    kf = torch.repeat_interleave(k, group, dim=2)  # (B, Sk, Hq, D)
    vf = torch.repeat_interleave(v, group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * scale

    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]   # (Sq, 1)
    kpos = torch.arange(Sk, device=q.device)[None, :]              # (1, Sk)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    if chunk is not None:
        mask &= torch.div(qpos, chunk, rounding_mode="floor") == \
            torch.div(kpos, chunk, rounding_mode="floor")
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf.float())
    return out.to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """Optional residual add, then ``x * rsqrt(mean(x²) + eps) * w`` in f32."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)
