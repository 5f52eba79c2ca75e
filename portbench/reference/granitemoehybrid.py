"""Plain float32 forward of Granite 4.0-H (``granitemoehybrid``), one chip's
share of its experts.

The frozen reference that decides ``correct``: plain ``torch`` operations,
no kernels, no cache, no batching, TF32 off. It reads the benchmark's own
weight dict (keys as ``portbench/arch/granitemoehybrid.py``'s ``layout``
names them) and the configuration's ``model`` block, and imports nothing of
the program.

The model, as the published description has it: embeddings times
``embed_scale`` (``embedding_multiplier``); per layer ``i``, by
``layer_types[i]``,

- ``x += r * mixer(rmsnorm(x))``, the mixer a Mamba-2 layer (in_proj to
  [z | xBC | dt]; a depthwise causal conv with bias and SiLU over xBC; dt =
  softplus(dt + dt_bias), A = -exp(A_log); the SSD sum, here in its block
  form over chunks of the published ``mamba_chunk_size``; + D x; gated
  RMSNorm of y * silu(z); out_proj) or NoPE GQA attention with scores
  scaled by ``attn_scale`` (``attention_multiplier``);
- ``x += r * (moe(h) + shared(h))`` with ``h = rmsnorm(x)``: the router's
  logits over all ``num_experts``, the top ``top_k`` of them, gates the
  softmax over those k logits; every (token, choice) is kept (dropless);

with ``r`` the ``residual_scale`` (``residual_multiplier``), then a final
RMSNorm and the tied head, logits times ``logit_scale`` (1 /
``logits_scaling``). Logits cover the real vocabulary only.

Departures, as the program has them: the MoE adds only the part of the
experts this chip holds, ``[expert_offset, expert_offset + experts_held)``
(a chip's share of an expert-parallel layer; the other chips' parts are
left out, in the program and here alike), with the shared expert whole;
RMSNorm's eps is the configuration's ``norm_eps`` (1e-6) where Granite has
1e-5, in every norm, the Mamba-2 gated norm included.

``quant="fp8"`` is the control: every linear layer's input rows and weight
columns (the router and the head included) rounded to float8 e4m3 (each row
or column scaled to the format's 448 first), the products then taken in
float32: the W8A8 step a lower precision than the configuration's bfloat16
would take.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

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


def _linear(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def _swiglu(h, up, gate, down, quant):
    return _linear(F.silu(_linear(h, gate, quant)) * _linear(h, up, quant), down, quant)


def _ssd(x, a, b, c, chunk: int):
    """The SSD sum y_t = sum_{s <= t} C_t . (prod_{s < r <= t} exp(a_r)) B_s x_s
    in its block form. x (S, H, P) already times dt; a (S, H) = dt * A;
    b, c (S, H, N). Chunk by chunk: the diagonal block's masked decay matrix,
    then the state carried in from the chunks before."""
    S, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    h = torch.zeros(H, P, N, dtype=x.dtype, device=x.device)
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        xs, bs, cs_, cum = x[lo:hi], b[lo:hi], c[lo:hi], torch.cumsum(a[lo:hi], 0)
        Q = hi - lo
        diff = cum[:, None, :] - cum[None, :, :]                    # (i, j, H)
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
        scores = torch.einsum("ihn,jhn->ijh", cs_, bs) * decay     # (i, j, H)
        y[lo:hi] = (torch.einsum("ijh,jhp->ihp", scores, xs)
                    + torch.einsum("ihn,hpn->ihp", cs_, h) * torch.exp(cum)[:, :, None])
        tail = torch.exp(cum[-1][None, :] - cum)                    # (j, H)
        h = (torch.exp(cum[-1])[:, None, None] * h
             + torch.einsum("jhn,jh,jhp->hpn", bs, tail, xs))
    return y


def _mamba(h, weights, p, model, quant):
    """One Mamba-2 mixer over (S, d)."""
    S = h.shape[0]
    H, P, G, N = model["ssm_heads"], model["ssm_headdim"], model["ssm_groups"], \
        model["ssm_state"]
    di = H * P
    proj = _linear(h, weights[p + "in_proj.w"], quant)
    z, xBC, dt = proj[:, :di], proj[:, di:2 * di + 2 * G * N], proj[:, 2 * di + 2 * G * N:]
    w, K = weights[p + "conv.w"].float(), weights[p + "conv.w"].shape[0]
    padded = F.pad(xBC, (0, 0, K - 1, 0))
    conv = sum(padded[k:k + S] * w[k] for k in range(K)) + weights[p + "conv.b"].float()
    xBC = F.silu(conv)
    x = xBC[:, :di].reshape(S, H, P)
    rep = H // G
    b = xBC[:, di:di + G * N].reshape(S, G, N).repeat_interleave(rep, dim=1)
    c = xBC[:, di + G * N:].reshape(S, G, N).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt + weights[p + "dt_bias"].float())             # (S, H)
    A = -torch.exp(weights[p + "A_log"].float())
    y = _ssd(x * dt[:, :, None], dt * A, b, c, model["mamba_chunk_size"])
    y = (y + weights[p + "D"].float()[:, None] * x).reshape(S, di)
    y = _rmsnorm(y * F.silu(z), weights[p + "norm.scale"], model["norm_eps"])
    return _linear(y, weights[p + "out_proj.w"], quant)


def _attention(h, weights, p, model, quant, block: int):
    """NoPE causal GQA over (S, d), query rows in blocks."""
    S = h.shape[0]
    H, Hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    q = _linear(h, weights[p + "wq.w"], quant).view(S, H, hd)
    group = H // Hkv
    k = _linear(h, weights[p + "wk.w"], quant).view(S, Hkv, hd)
    v = _linear(h, weights[p + "wv.w"], quant).view(S, Hkv, hd)
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)          # (H, S, hd)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=h.device)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = torch.einsum("qhd,hkd->hqk", q[lo:hi], k[:, :hi]) * model["attn_scale"]
        keep = kpos[None, :hi] <= torch.arange(lo, hi, device=h.device)[:, None]
        s = s.masked_fill(~keep[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1), v[:, :hi])
    return _linear(out.reshape(S, H * hd), weights[p + "wo.w"], quant)


def _moe(h, weights, p, model, quant):
    """The held experts' part of a dropless top-k MoE, then the shared expert."""
    logits = _linear(h, weights[p + "router.w"], quant)              # (S, E)
    top, chosen = logits.topk(model["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    lo = model["expert_offset"]
    for j in range(model["experts_held"]):
        tok, slot = (chosen == lo + j).nonzero(as_tuple=True)
        if tok.numel():
            part = _swiglu(h[tok], weights[p + "experts.up.w"][j],
                           weights[p + "experts.gate.w"][j], weights[p + "experts.down.w"][j],
                           quant)
            out.index_add_(0, tok, gates[tok, slot][:, None] * part)
    return out + _swiglu(h, weights[p + "shared0.up.w"], weights[p + "shared0.gate.w"],
                         weights[p + "shared0.down.w"], quant)


@torch.no_grad()
def logits_at(model: dict, weights: dict, tokens: torch.Tensor, rows: torch.Tensor,
              quant: str | None = None, block: int = 1024) -> torch.Tensor:
    """Logits (len(rows), vocab_size) in float32 of one sequence ``tokens`` (S,)
    at positions ``rows``: the full forward over all S positions, the head on
    the rows asked for."""
    model = dict(model, ssm_heads=model["ssm_expand"] * model["d_model"] // model["ssm_headdim"])
    with no_tf32():
        eps, r = model["norm_eps"], model["residual_scale"]
        x = weights["embed.table"][tokens.long()].float() * model["embed_scale"]
        for i, kind in enumerate(model["layer_types"]):
            p = f"layers.{i}."
            h = _rmsnorm(x, weights[p + "norm1.scale"], eps)
            if kind == "mamba":
                x = x + r * _mamba(h, weights, p + "ssm.", model, quant)
            else:
                x = x + r * _attention(h, weights, p + "attn.", model, quant, block)
            h = _rmsnorm(x, weights[p + "norm2.scale"], eps)
            x = x + r * _moe(h, weights, p + "moe.", model, quant)
        h = _rmsnorm(x[rows], weights["final_norm.scale"], eps)
        head = weights["embed.table"][: model["vocab_size"]]
        return _linear(h, head.t(), quant) * model["logit_scale"]


