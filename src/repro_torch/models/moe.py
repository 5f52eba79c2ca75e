"""Mixture-of-Experts layer: top-k router, capacity-based dispatch and the
grouped expert GEMMs (the CUDA grouped-matmul kernel on the card).

Port of ``repro.models.moe``. ``moe_apply`` dispatches on ``cfg.moe_impl``
as the reference does: ``"shard_map"`` under an active mesh with a
``"model"`` axis (``sharding.partition.use_mesh``) takes the
expert-parallel :func:`moe_apply_shard_map`; everything else takes
:func:`moe_apply_gspmd`, the global dispatch, which runs the local dispatch
of one shard of the mesh path over the experts the model holds (all of
them, or ``cfg.experts_held``: one chip of an expert-parallel deployment).
Dispatch is static-shape (capacity factor), and tokens over capacity pass
through the residual; a capacity factor of ``num_experts / top_k`` gives
every expert room for every token, so none is dropped.

Every step is written so that ``torch.func.vmap`` batches it across
tenants (the server's coalesced decode): no ``.item()``, no data-dependent
shapes, no ``bincount`` or ``one_hot``. ``jnp.argsort(stable=True)``
becomes ``torch.sort(stable=True)``, the bincount a ``scatter_add``, the
dispatch scatter an ``index_put`` (every other entry into a junk row) and ``segment_sum`` a
sum over the K choices of each token. Capacity is computed from the member's own token count.

Inside :func:`tally` (the eager prefill, while spans record) each layer
adds, on the calling thread, its rows routed to the experts it holds (a
device tensor, read once by the caller) and the rows its grouped products
computed.
"""
from __future__ import annotations

import contextlib
import math
import threading
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
    """The routed experts this model holds (``cfg.held_experts`` of them)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, E, dt = cfg.d_model, cfg.expert_d_ff, cfg.held_experts, cfg.param_torch_dtype
        self.up = ExpertWeights(E, d, f, dt, device)
        self.gate = ExpertWeights(E, d, f, dt, device)
        self.down = ExpertWeights(E, f, d, dt, device)


class MoE(nn.Module):
    """``router.w`` (d, E) over every expert, ``experts.{up,gate,down}.w``
    of the held ones and the shared experts ``shared{i}`` (swiglu MLPs of
    width ``shared_expert_d_ff``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.param_torch_dtype
        self.router = L.Linear(cfg.d_model, cfg.num_experts, dtype=dt, device=device)
        self.experts = Experts(cfg, device)
        for i in range(cfg.num_shared_experts):
            self.add_module(f"shared{i}", L.MLP(cfg, device, d_ff=cfg.shared_expert_d_ff))


_counts = threading.local()    # .rows: the open tally of this thread, if any


@contextlib.contextmanager
def tally():
    """Collect, on this thread, one ``(routed, rows)`` pair a MoE layer:
    ``routed`` the (token, choice) rows sent to the experts the layer holds
    (a 0-dim device tensor), ``rows`` the rows its grouped products computed."""
    outer = getattr(_counts, "rows", None)
    _counts.rows = []
    try:
        yield _counts.rows
    finally:
        _counts.rows = outer


def _count(routed: torch.Tensor, rows: int) -> None:
    out = getattr(_counts, "rows", None)
    if out is not None:
        out.append((routed.sum(), rows))


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows an expert takes, from the capacity factor, at least 8 and at
    most every token (a token picks an expert at most once)."""
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


def _held_part(cdt, tokens, flat_expert, pos, keep, gate_vals, lo: int, E_loc: int, C: int,
               up_w, gate_w, down_w, T: int, K: int) -> torch.Tensor:
    """The f32 combine of the part experts ``[lo, lo + E_loc)`` give: their
    (token, choice) rows of ``tokens`` (T·K, d) dispatched to (E_loc, C, d),
    the three grouped GEMMs with their weights, gathered back weighted by
    the gates; every other row adds nothing."""
    dev, d = tokens.device, tokens.shape[-1]
    local_e = flat_expert - lo
    mine = (local_e >= 0) & (local_e < E_loc) & keep
    row = torch.clamp(local_e, 0, E_loc - 1) * C + pos
    # Dispatch: every kept (token, k) of these experts owns its (expert,
    # slot) row, so the tokens are copied in; the other entries (half or
    # more of them) all go to one junk row past the end, never read.
    # Adding them in as zeros, as the global dispatch does, piles every one
    # onto a few rows, whose atomic adds serialize on the card.
    flat = torch.zeros((E_loc * C + 1, d), dtype=cdt, device=dev).index_put(
        (torch.where(mine, row, E_loc * C),), tokens)
    disp = flat[:E_loc * C].view(E_loc, C, d)
    eout = _expert_ffn(cdt, disp, up_w, gate_w, down_w)        # (E_loc, C, d)
    weights = torch.where(mine, gate_vals.reshape(-1), 0.0)
    _count(mine, E_loc * C)
    return _combine(eout, torch.where(mine, row, 0), weights, T, K)


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
    """The global dispatch: every held expert's tokens gathered from all of
    x. The router scores all ``num_experts`` and picks the top k of them;
    the layer computes the part its held experts ``[expert_offset,
    expert_offset + held_experts)`` give (the local dispatch of one shard of
    :func:`moe_apply_shard_map`, with no exchange), and the shared experts
    whole. Where the model holds a share, what the other chips' experts
    would add is left out."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    cdt = cfg.compute_dtype
    T = B * S
    xt = x.reshape(T, d)

    probs, gate_vals, expert_idx = route(p, cfg, xt)
    aux = _aux(cfg, probs, expert_idx)

    C = capacity(cfg, T)
    flat_expert = expert_idx.reshape(-1)                       # (T*K,)
    pos, keep = _positions(flat_expert, E, C)
    tokens = xt.index_select(0, torch.arange(T, device=x.device).repeat_interleave(K)).to(cdt)
    ex = p.experts
    part = _held_part(cdt, tokens, flat_expert, pos, keep, gate_vals, cfg.expert_offset,
                      cfg.held_experts, C, ex.up.w, ex.gate.w, ex.down.w, T, K)
    return _shared_experts(p, cfg, x, part.to(cdt).reshape(B, S, d)), aux


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
    if cfg.held_experts != E:
        raise ValueError(f"the mesh's expert shards split all {E} experts; this model "
                         f"holds {cfg.held_experts}")
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
                w = [t.narrow(0, m * E_loc, E_loc).to(dev)
                     for t in (ex.up.w, ex.gate.w, ex.down.w)]
                part = _held_part(cdt, tokens.to(dev), flat_expert.to(dev), pos.to(dev),
                                  keep.to(dev), gate_vals.to(dev), m * E_loc, E_loc, C,
                                  *w, T, K).to(home)
            combined = part if combined is None else combined + part
        outs.append(combined.reshape(Bl, S, d).to(cdt))
    out = torch.cat(outs) if dp > 1 else outs[0]
    aux = torch.stack(auxes).mean() if dp > 1 else auxes[0]
    return _shared_experts(p, cfg, x, out), aux

