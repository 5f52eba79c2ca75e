"""Mixture-of-Experts layer: top-k router, capacity-based dispatch and the
grouped expert GEMMs (the CUDA grouped-matmul kernel on the card).

Port of ``repro.models.moe``. ``moe_apply`` dispatches on ``cfg.moe_impl``
as the reference does: ``"shard_map"`` under an active mesh with a
``"model"`` axis (``sharding.partition.use_mesh``) takes the
expert-parallel :func:`moe_apply_shard_map`; everything else takes
:func:`moe_apply_gspmd`, the global dispatch. Dispatch is static-shape
(capacity factor), and tokens over capacity pass through the residual.

Every step is written so that ``torch.func.vmap`` batches it across
tenants (the server's coalesced decode): no ``.item()``, no data-dependent
shapes, no ``bincount`` or ``one_hot``. ``jnp.argsort(stable=True)``
becomes ``torch.sort(stable=True)``, the bincount a ``scatter_add``, the
dispatch scatter ``index_put(accumulate=True)`` and ``segment_sum`` a
sum over the K choices of each token. Capacity is computed from the member's own token count.
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from ..sharding import partition as _partition
from ..sharding import replay as _shreplay
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


def _aux(cfg: ModelConfig, probs: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss: E * sum_e f_e * p_e."""
    E = cfg.num_experts
    me = probs.mean(dim=0)
    top1 = (expert_idx[:, :1] == torch.arange(E, device=probs.device)).float()
    return E * torch.sum(me * top1.mean(dim=0)) * cfg.router_aux_weight


def _positions(flat_expert: torch.Tensor, E: int, C: int):
    """Capacity positions: the rank of each (token, k) among its expert's
    entries in the stable order of the flattened (T, K) expert ids; and
    whether it is kept (rank < C)."""
    dev = flat_expert.device
    TK = flat_expert.shape[0]
    sorted_expert, sort_idx = torch.sort(flat_expert, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add(
        0, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(counts, dim=0) - counts
    ranks = torch.arange(TK, device=dev) - offsets.gather(0, sorted_expert)
    pos = torch.zeros(TK, dtype=torch.long, device=dev).scatter(0, sort_idx, ranks)
    return pos, pos < C


def _expert_ffn(cdt, disp: torch.Tensor, up_w, gate_w, down_w) -> torch.Tensor:
    """The three grouped GEMMs (grouped matmul kernel) of (E, C, d) tokens."""
    up = ops.grouped_matmul(disp, up_w.to(cdt))
    gate = ops.grouped_matmul(disp, gate_w.to(cdt))
    h = (F.silu(gate.float()) * up.float()).to(cdt)
    return ops.grouped_matmul(h, down_w.to(cdt))


def _combine(eout: torch.Tensor, rows: torch.Tensor, weights: torch.Tensor,
             T: int, K: int) -> torch.Tensor:
    """Gather expert outputs back to tokens, weighted by gates, in f32. The
    reference's segment_sum over tok_ids adds each token's K rows, which
    lie next to each other, so it is a sum over K: an index_add would do
    the same adds with atomics on the card, in an order that varies run to
    run."""
    d = eout.shape[-1]
    gathered = eout.reshape(-1, d).index_select(0, rows)
    return (gathered.float() * weights[:, None]).reshape(T, K, d).sum(dim=1)


def _shared_experts(p: MoE, cfg: ModelConfig, x: torch.Tensor, out: torch.Tensor):
    for i in range(cfg.num_shared_experts):
        out = out + L.mlp_apply(getattr(p, f"shared{i}"), cfg, x)
    return out


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). Dispatches on ``cfg.moe_impl``:
    ``"shard_map"`` under an active mesh with a ``"model"`` axis runs
    expert-parallel, anything else the global dispatch."""
    mesh = _partition.active_mesh()
    if cfg.moe_impl == "shard_map" and mesh is not None and "model" in mesh.axis_names:
        return moe_apply_shard_map(p, cfg, x)
    return moe_apply_gspmd(p, cfg, x)


def moe_apply_gspmd(p: MoE, cfg: ModelConfig, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global dispatch: every expert's tokens gathered from all of x."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    cdt = cfg.compute_dtype
    T = B * S
    xt = x.reshape(T, d)
    dev = x.device

    probs, gate_vals, expert_idx = route(p, cfg, xt)
    aux = _aux(cfg, probs, expert_idx)

    C = capacity(cfg, T)
    flat_expert = expert_idx.reshape(-1)                       # (T*K,)
    pos, keep = _positions(flat_expert, E, C)

    # dispatch: scatter tokens into (E, C, d)
    tok_ids = torch.arange(T, device=dev).repeat_interleave(K)
    safe_pos = torch.where(keep, pos, C - 1)
    contrib = torch.where(keep[:, None], xt.index_select(0, tok_ids).to(cdt), 0)
    disp = torch.zeros((E, C, d), dtype=cdt, device=dev).index_put(
        (flat_expert, safe_pos), contrib, accumulate=True)

    ex = p.experts
    eout = _expert_ffn(cdt, disp, ex.up.w, ex.gate.w, ex.down.w)   # (E, C, d)
    weights = torch.where(keep, gate_vals.reshape(-1), 0.0)
    combined = _combine(eout, flat_expert * C + safe_pos, weights, T, K)
    out = combined.to(cdt).reshape(B, S, d)
    return _shared_experts(p, cfg, x, out), aux


def moe_apply_shard_map(p: MoE, cfg: ModelConfig, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with local dispatch over the active mesh (the
    reference's ``shard_map`` form: its static root-task distribution
    applied to experts, decided once by the sharding).

    x is split over the mesh's data axes ("pod", "data"); experts over
    "model", ``E_loc = E / model`` a shard. For each data shard: its tokens
    are routed once (the router is replicated), capacity comes from the
    shard's own token count, and each model shard m dispatches only to its
    experts ``[m·E_loc, (m+1)·E_loc)``, runs the three grouped GEMMs on its
    device and returns its partial f32 combine. The reference's ``psum``
    over "model" is the sum of the partials in shard order on the caller's
    device (no atomics); ``aux`` is averaged over the data shards (its
    ``pmean``). One process drives every shard in turn.
    """
    mesh = _partition.active_mesh()
    E, K = cfg.num_experts, cfg.top_k
    tp = mesh.shape["model"]
    if E % tp:
        raise ValueError(f"{E} experts do not split over model={tp}")
    E_loc = E // tp
    cdt = cfg.compute_dtype
    B, S, d = x.shape
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    if B % dp:
        raise ValueError(f"batch {B} does not split over {dp} data shards")
    Bl, home = B // dp, x.device
    T = Bl * S
    C = capacity(cfg, T)
    ex = p.experts
    outs, auxes = [], []
    for i in range(dp):
        coords, rest = {}, i
        for a in reversed(dp_axes):
            rest, coords[a] = divmod(rest, mesh.shape[a])
        dev0 = mesh.device_at({**coords, "model": 0})
        xt = x[i * Bl:(i + 1) * Bl].reshape(T, d).to(dev0)
        router = types.SimpleNamespace(router=types.SimpleNamespace(w=p.router.w.to(dev0)))
        with _shreplay.at_position(mesh, {**coords, "model": 0}, "all-to-all", "all-to-all"):
            probs, gate_vals, expert_idx = route(router, cfg, xt)
            auxes.append(_aux(cfg, probs, expert_idx).to(home))
            flat_expert = expert_idx.reshape(-1)
            pos, keep = _positions(flat_expert, E, C)
            tok_ids = torch.arange(T, device=dev0).repeat_interleave(K)
            tokens = xt.index_select(0, tok_ids).to(cdt)
        combined = None
        for m in range(tp):
            dev = mesh.device_at({**coords, "model": m})
            with _shreplay.at_position(mesh, {**coords, "model": m}, "all-to-all", "all-to-all"):
                local_e = flat_expert.to(dev) - m * E_loc
                mine = (local_e >= 0) & (local_e < E_loc) & keep.to(dev)
                row = torch.clamp(local_e, 0, E_loc - 1) * C + pos.to(dev)
                # Dispatch: every kept (token, k) of this shard's experts
                # owns its (expert, slot) row, so the tokens are copied in;
                # the other entries (half or more of them) all go to one
                # junk row past the end, never read. Adding them in as
                # zeros, as the global dispatch does, piles every one onto
                # a few rows, whose atomic adds serialize on the card.
                flat = torch.zeros((E_loc * C + 1, d), dtype=cdt, device=dev).index_put(
                    (torch.where(mine, row, E_loc * C),), tokens.to(dev))
                disp = flat[:E_loc * C].view(E_loc, C, d)
                w = [t.narrow(0, m * E_loc, E_loc).to(dev)
                     for t in (ex.up.w, ex.gate.w, ex.down.w)]
                eout = _expert_ffn(cdt, disp, *w)               # (E_loc, C, d)
                weights = torch.where(mine, gate_vals.reshape(-1).to(dev), 0.0)
                part = _combine(eout, torch.where(mine, row, 0), weights, T, K).to(home)
            combined = part if combined is None else combined + part
        outs.append(combined.reshape(Bl, S, d).to(cdt))
    out = torch.cat(outs) if dp > 1 else outs[0]
    aux = torch.stack(auxes).mean() if dp > 1 else auxes[0]
    return _shared_experts(p, cfg, x, out), aux
