"""Mixture-of-Experts layer: top-k router, capacity-based dispatch and the
grouped expert GEMMs (the CUDA grouped-matmul kernel on the card).

Port of the GSPMD path of ``repro.models.moe`` (``moe_apply_gspmd``), which
is also what the reference runs when no mesh is active; the expert-parallel
``moe_apply_shard_map`` needs a mesh and waits for multi-device replay
(ROADMAP.md). Dispatch is static-shape (capacity factor), and tokens over
capacity pass through the residual.

Every step is written so that ``torch.func.vmap`` batches it across
tenants (the server's coalesced decode): no ``.item()``, no data-dependent
shapes, no ``bincount`` or ``one_hot``. ``jnp.argsort(stable=True)``
becomes ``torch.sort(stable=True)``, the bincount a ``scatter_add``, the
dispatch scatter ``index_put(accumulate=True)`` and ``segment_sum`` a
sum over the K choices of each token. Capacity is computed from the member's own token count.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from . import layers as L


class ExpertWeights(nn.Module):
    """One stacked expert projection: ``w`` (E, d_in, d_out), fan-in d_in."""

    def __init__(self, E: int, d_in: int, d_out: int, dtype, device=None):
        super().__init__()
        self.w = L._param(E, d_in, d_out, dtype=dtype, device=device)

    def init_(self, generator: torch.Generator) -> None:
        L.init_dense_(self.w, self.w.shape[1], generator)


class Experts(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, E, dt = cfg.d_model, cfg.expert_d_ff, cfg.num_experts, cfg.param_torch_dtype
        self.up = ExpertWeights(E, d, f, dt, device)
        self.gate = ExpertWeights(E, d, f, dt, device)
        self.down = ExpertWeights(E, f, d, dt, device)


class MoE(nn.Module):
    """``router.w`` (d, E), ``experts.{up,gate,down}.w`` and the shared
    experts ``shared{i}`` (swiglu MLPs of width ``expert_d_ff``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.param_torch_dtype
        self.router = L.Linear(cfg.d_model, cfg.num_experts, dtype=dt, device=device)
        self.experts = Experts(cfg, device)
        for i in range(cfg.num_shared_experts):
            self.add_module(f"shared{i}", L.MLP(cfg, device, d_ff=cfg.expert_d_ff))


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, min(n_tokens, math.ceil(c / 8) * 8))


def route(p: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """Router of (T, d) tokens: (probs (T, E), gate_vals (T, K), expert_idx
    (T, K)). The product takes the compute-dtype inputs to an f32 result
    (the reference's ``preferred_element_type``); ``topk`` returns the K
    choices in descending order, as ``lax.top_k`` does, which fixes the
    drop order below."""
    cdt = cfg.compute_dtype
    logits = torch.matmul(xt.to(cdt).float(), p.router.w.to(cdt).float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). The port has no mesh, so every
    ``moe_impl`` takes this path, as the reference does without a mesh."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    cdt = cfg.compute_dtype
    T = B * S
    xt = x.reshape(T, d)
    dev = x.device

    probs, gate_vals, expert_idx = route(p, cfg, xt)

    # aux load-balance loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    top1 = (expert_idx[:, :1] == torch.arange(E, device=dev)).float()
    aux = E * torch.sum(me * top1.mean(dim=0)) * cfg.router_aux_weight

    # capacity positions: rank of each (token, k) among its expert's
    # entries in the stable order of the flattened (T, K) expert ids
    C = capacity(cfg, T)
    flat_expert = expert_idx.reshape(-1)                       # (T*K,)
    TK = flat_expert.shape[0]
    sorted_expert, sort_idx = torch.sort(flat_expert, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add(
        0, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(counts, dim=0) - counts
    ranks = torch.arange(TK, device=dev) - offsets.gather(0, sorted_expert)
    pos = torch.zeros(TK, dtype=torch.long, device=dev).scatter(0, sort_idx, ranks)
    keep = pos < C

    # dispatch: scatter tokens into (E, C, d)
    tok_ids = torch.arange(T, device=dev).repeat_interleave(K)
    safe_pos = torch.where(keep, pos, C - 1)
    contrib = torch.where(keep[:, None], xt.index_select(0, tok_ids).to(cdt), 0)
    disp = torch.zeros((E, C, d), dtype=cdt, device=dev).index_put(
        (flat_expert, safe_pos), contrib, accumulate=True)

    # expert GEMMs (grouped matmul kernel)
    ex = p.experts
    up = ops.grouped_matmul(disp, ex.up.w.to(cdt))
    gate = ops.grouped_matmul(disp, ex.gate.w.to(cdt))
    h = (F.silu(gate.float()) * up.float()).to(cdt)
    eout = ops.grouped_matmul(h, ex.down.w.to(cdt))            # (E, C, d)

    # combine: gather expert outputs back to tokens, weighted by gates. The
    # reference's segment_sum over tok_ids adds each token's K rows, which lie
    # next to each other, so it is a sum over K: an index_add would do the
    # same adds with atomics on the card, in an order that varies run to run
    gathered = eout.reshape(E * C, d).index_select(0, flat_expert * C + safe_pos)
    weights = torch.where(keep, gate_vals.reshape(-1), 0.0)
    combined = (gathered.float() * weights[:, None]).reshape(T, K, d).sum(dim=1)
    out = combined.to(cdt).reshape(B, S, d)

    for i in range(cfg.num_shared_experts):
        out = out + L.mlp_apply(getattr(p, f"shared{i}"), cfg, x)
    return out, aux
