"""Train / serve step construction (port of ``repro.training.step``).

Two granularities of the train step, as in the reference:

* ``make_train_step`` — the production path: one function (forward +
  backward + clip + AdamW). The reference's launcher jits it with
  ``donate_argnums=(0, 1)``; here the params and moments it is given are
  updated in place (``Optimizer.update_``), so one copy of each is held.
  Given a ``mesh`` it runs data parallel over the mesh's batch axes, one
  controller driving every batch shard (the reference ``jit``s the same
  step with ``in_shardings`` and GSPMD partitions it).

* ``make_tdg_train_region`` — the paper-faithful fine-grained path: the
  step as a ``TaskGraphRegion`` of ``2n + 5`` tasks (embed, per-layer
  forward, head loss, head backward, per-layer recompute-VJP backward, embed
  backward, optimizer update) that donates ``params`` and ``opt_state``.
  It runs through record, ``EagerExecutor``, ``lower_tdg(jit=False)`` and
  the captured CUDA-graph replay; numerically the fused step's.

Params are the name -> tensor dict of ``models.model.params_of``; the
optimizer state is ``Optimizer.init`` of it.
"""
from __future__ import annotations

import types

import torch

from ..configs.base import ModelConfig
from ..core import TaskGraphRegion
from ..launch.mesh import ReplayMesh
from ..models import layers as L
from ..models import model as M
from ..models import transformer as T
from ..optim.adamw import Optimizer, apply_updates
from ..sharding import partition as _partition
from ..sharding import replay as _shreplay


def _loss_and_grads(cfg: ModelConfig, params: dict, batch: dict,
                    weight: torch.Tensor | None = None):
    """``loss_fn`` on ``batch`` and the gradients of ``weight * loss`` (of
    the loss itself without a weight) with respect to ``params``."""
    with torch.enable_grad():
        diff = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, metrics = M.loss_fn(M.bind(cfg, diff), cfg, batch)
        target = loss if weight is None else loss * weight
        grads = torch.autograd.grad(target, list(diff.values()))
    return {k: v.detach() for k, v in metrics.items()}, dict(zip(diff, grads))


def sharded_loss_and_grads(cfg: ModelConfig, params: dict, batch: dict,
                           mesh: ReplayMesh) -> tuple[dict, dict]:
    """The whole batch's loss metrics and gradients, data parallel over
    ``mesh``'s batch axes, one controller driving every batch shard.

    The batch splits into one contiguous chunk a batch shard
    (``replay.lane_chunks``: the batch must be a multiple of the batch
    axes' size). Each chunk's forward and backward run on its shard's
    device against ``replicate``d params (on virtual positions nothing is
    copied), with the loss weighted by the chunk's share of the tokens
    ``loss_fn`` counts, so the weighted sum is the whole batch's mean.
    MoE layers with ``moe_impl="shard_map"`` take their experts over the
    ``"model"`` positions of the chunk's row of the mesh. The gradients and
    metrics come back to the caller's device and are summed there in shard
    order. Dense leaves are computed whole by each batch shard, never split
    over ``"model"`` (GSPMD would split them). Returns ``(metrics, grads)``.
    """
    home = batch["tokens"].device
    chunks = _shreplay.lane_chunks(batch["tokens"].shape[0], mesh)
    rows = [{k: v[a:b] for k, v in batch.items()} for _, a, b in chunks]
    counts = [M.loss_labels(r)[1].sum() for r in rows]
    total = torch.clamp(torch.stack(counts).sum(), min=1.0)
    metrics, grads = {}, {}
    for coords, (device, _, _), row, count in zip(_shreplay.shard_coords(mesh), chunks,
                                                  rows, counts):
        with _shreplay.at_position(mesh, coords, "all-gather", "all-reduce"), \
                _partition.use_mesh(mesh.select(coords)):
            weight = (count / total).to(device)
            m, g = _loss_and_grads(cfg, _shreplay.replicate(params, device),
                                   _shreplay.replicate(row, device), weight)
            m = {k: v * weight if k != "tokens" else v for k, v in m.items()}
        for tree, part in ((metrics, m), (grads, g)):
            for k, v in part.items():
                v = v.to(home)
                tree[k] = v if k not in tree else tree[k] + v
    return metrics, grads


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, mesh: ReplayMesh | None = None):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``, with
    ``params`` and ``opt_state`` updated in place and returned. With
    ``mesh``, the loss and gradients come from
    :func:`sharded_loss_and_grads`; clipping and AdamW then run once, on
    the params' device."""

    def train_step(params, opt_state, batch):
        if mesh is None:
            metrics, grads = _loss_and_grads(cfg, params, batch)
        else:
            metrics, grads = sharded_loss_and_grads(cfg, params, batch, mesh)
        opt_metrics = optimizer.update_(grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_serve_step(cfg: ModelConfig):
    """(params, tokens (B,1), pos (B,), caches) -> (next_tokens, new_caches)."""

    def serve_step(params, tokens, pos, caches):
        logits, caches = M.decode_step(params, cfg, tokens, pos, caches)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, caches

    return serve_step


# ---------------------------------------------------------------------------
# Fine-grained TDG step (per-layer fwd/bwd tasks)
# ---------------------------------------------------------------------------

def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A differentiable alias of ``t`` (same storage, fresh autograd leaf)."""
    return t.detach().requires_grad_()


def _head_ce(cfg: ModelConfig, final_norm: dict, table, xn, toks) -> torch.Tensor:
    """The region's CE of the final hidden state: final norm (the family's:
    ``final_norm`` holds its ``final_norm.*`` tensors), unembed and a
    log-softmax over ALL padded_vocab columns. Unlike the fused step's
    ``_logits`` it does not mask the pad columns (vocab_size..padded_vocab),
    as the reference's ``head_loss`` / ``head_bwd`` do not; the two agree
    where vocab_size is a multiple of 256."""
    norm = types.SimpleNamespace(**{k.split(".")[-1]: v for k, v in final_norm.items()})
    h = T.norm(cfg, norm, xn)
    logits = L.unembed(types.SimpleNamespace(table=table), h,
                       cfg.compute_dtype) * cfg.logit_scale
    labels, mask = M.shifted_labels(toks)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum()


def make_tdg_train_region(cfg: ModelConfig, optimizer: Optimizer,
                          name: str = "tdg_train_step") -> TaskGraphRegion:
    """Build the per-layer task region. Buffers:
    in : params (name -> tensor dict), opt_state, tokens
    out: params, opt_state, loss

    As in the reference, the region runs the decoder alone: it passes no
    encoder output (an encdec block then skips its cross-attention), and
    the parameters no task reaches (the encoder's, the cross-attention's)
    get zero gradients.
    """
    n = cfg.num_layers
    table_key = "embed.table" if cfg.tie_embeddings else "head.table"
    norm_keys = [f"final_norm.{k}" for k, _ in
                 M._skeleton(cfg).final_norm.named_parameters()]

    def layer_params(p: dict, i: int) -> dict:
        prefix = f"layers.{i}."
        return {k: v for k, v in p.items() if k.startswith(prefix)}

    def build(g, params, opt_state, tokens):
        # embed task
        def embed_fn(p, toks):
            B, Sq = toks.shape
            pos = torch.arange(Sq, dtype=torch.int32, device=toks.device)[None].expand(B, Sq)
            x = L.embed(types.SimpleNamespace(table=p["embed.table"]), toks,
                        cfg.compute_dtype) * cfg.embed_scale
            return x, pos
        g.task(embed_fn, ins=["params", "tokens"], outs=["x0", "positions"],
               name="embed")

        # forward chain
        for i in range(n):
            def fwd(p, x, positions, _i=i):
                y, aux, _ = T.block_apply(M.bind(cfg, p, layer=_i), cfg, x, positions,
                                         layer_idx=_i)
                return y, aux
            g.task(fwd, ins=["params", f"x{i}", "positions"],
                   outs=[f"x{i + 1}", f"aux{i}"], name=f"fwd_L{i}")

        # loss head (+ grad wrt final hidden) as one task; the pad columns
        # are not masked (see _head_ce), as in the reference
        def head_loss(p, xn, toks, *auxes):
            with torch.enable_grad():
                xn_ = _leaf(xn)
                ce = _head_ce(cfg, {k: p[k] for k in norm_keys}, p[table_key], xn_, toks)
                (gxn,) = torch.autograd.grad(ce, xn_)
            loss = ce.detach() + sum(auxes)
            return loss, gxn
        g.task(head_loss,
               ins=["params", f"x{n}", "tokens"] + [f"aux{i}" for i in range(n)],
               outs=["loss", f"gx{n}"], name="head_loss")

        # head/final_norm param grads (recompute VJP; pad columns unmasked too)
        def head_bwd(p, xn, toks):
            with torch.enable_grad():
                fn_, tab_ = {k: _leaf(p[k]) for k in norm_keys}, _leaf(p[table_key])
                ce = _head_ce(cfg, fn_, tab_, xn, toks)
                *gfn, gtab = torch.autograd.grad(ce, [*fn_.values(), tab_])
            return dict(zip(norm_keys, gfn)), gtab
        g.task(head_bwd, ins=["params", f"x{n}", "tokens"],
               outs=["g_final_norm", "g_table"], name="head_bwd")

        # backward chain (one task per layer; recompute inside)
        for i in reversed(range(n)):
            def bwd(p, x, positions, gy, _i=i):
                lp = layer_params(p, _i)
                with torch.enable_grad():
                    lp_ = {k: _leaf(v) for k, v in lp.items()}
                    x_ = _leaf(x)
                    y, aux, _ = T.block_apply(M.bind(cfg, lp_, layer=_i), cfg, x_,
                                             positions, layer_idx=_i)
                    outs, cots = [y], [gy]
                    if aux.requires_grad:    # MoE: d loss / d aux = 1
                        outs.append(aux)
                        cots.append(torch.ones_like(aux))
                    grads = torch.autograd.grad(outs, [x_, *lp_.values()], cots,
                                                allow_unused=True)
                glp = {k: torch.zeros_like(v) if gk is None else gk
                       for (k, v), gk in zip(lp.items(), grads[1:])}
                return grads[0], glp
            g.task(bwd, ins=["params", f"x{i}", "positions", f"gx{i + 1}"],
                   outs=[f"gx{i}", f"glayer{i}"], name=f"bwd_L{i}")

        # embedding grad from gx0 + head grads
        def embed_bwd(p, toks, gx0, gtab, gfn):
            with torch.enable_grad():
                emb_ = _leaf(p["embed.table"])
                out = (L.embed(types.SimpleNamespace(table=emb_), toks, cfg.compute_dtype)
                       * cfg.embed_scale).float()
                (gemb,) = torch.autograd.grad(out, emb_, gx0.float())
            if cfg.tie_embeddings:
                return gemb + gtab, None, gfn
            return gemb, gtab, gfn
        g.task(embed_bwd, ins=["params", "tokens", "gx0", "g_table",
                               "g_final_norm"],
               outs=["g_embed", "g_head", "g_final_norm2"], name="embed_bwd")

        # assemble grads (in the params' key order) + optimizer update
        def opt_update(p, s, gemb, ghead, gfn, *glayers):
            found = {"embed.table": gemb, **gfn}
            if not cfg.tie_embeddings:
                found["head.table"] = ghead
            for gl in glayers:
                found.update(gl)
            grads = {k: found[k] if k in found else torch.zeros_like(v) for k, v in p.items()}
            updates, s2, _m = optimizer.update(grads, s, p)
            return apply_updates(p, updates), s2
        g.task(opt_update,
               ins=["params", "opt_state", "g_embed", "g_head",
                    "g_final_norm2"] + [f"glayer{i}" for i in range(n)],
               outs=["params", "opt_state"], name="opt_update")

    return TaskGraphRegion(build, name=name,
                           donate_slots=("params", "opt_state"),
                           outputs=("params", "opt_state", "loss"))
