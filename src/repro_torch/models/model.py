"""Model API: init, logits, and prefill / decode for serving.

Port of the serving path of ``repro.models.model`` for the dense, MoE and
SSM families. The decode step
is the payload that the taskgraph runtime records and replays: shape
stable and free of side effects (caches are returned, never written in
place), so one step can be ``torch.func.vmap``-ed across tenants.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from . import ssm as S
from . import transformer as T


class Model(nn.Module):
    """Parameter tree of the reference (``embed``, ``layers``, ``final_norm``,
    ``head`` when untied); the layer index is the ModuleList index where the
    reference stacks a leading ``L`` axis. Entries are uninitialized until
    :func:`init_params` or :func:`params_from_jax` fills them. ``device``
    is required: the model is built where the caller says, never on a
    default device."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = cfg.param_torch_dtype
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(T.Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, dt, device)
        self.head = (None if cfg.tie_embeddings
                     else L.Embedding(cfg.padded_vocab, cfg.d_model, dt, device))


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Model:
    """Random weights from ``generator``, on the generator's device.

    Dense weights (linear, embedding, expert and conv weights: every module
    with an ``init_``) are truncated normals with std fan_in^-1/2; norms are
    ones, biases zeros and the SSM's A_log, D and dt_bias constants, as in
    the reference. The numbers differ from JAX's for the same seed, so
    parity tests carry weights over with :func:`params_from_jax`.
    """
    model = Model(cfg, generator.device)
    for mod in model.modules():
        if hasattr(mod, "init_"):
            mod.init_(generator)
    return model


def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig,
                    device: torch.device | str) -> Model:
    """The port's model holding the reference's parameter pytree, on ``device``.

    ``np_params`` is the JAX tree as numpy arrays, layers stacked on a
    leading ``L`` axis: ``model.layers.3.attn.wq.w`` takes
    ``np_params["layers"]["attn"]["wq"]["w"][3]``, and likewise
    ``layers.*.moe.router.w``, ``layers.*.moe.experts.{up,gate,down}.w``,
    ``layers.*.attn.{qnorm,knorm}.scale``, ``layers.*.ssm.*`` and ``head``.
    """
    model = Model(cfg, device)
    for name, prm in model.named_parameters():
        path = name.split(".")
        layer = None
        if path[0] == "layers":
            layer, path = int(path[1]), ["layers"] + path[2:]
        node = np_params
        for key in path:
            node = node[key]
        arr = np.asarray(node if layer is None else node[layer])
        if arr.shape != tuple(prm.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != {tuple(prm.shape)}")
        prm.copy_(torch.from_numpy(arr.astype(np.float32)).to(prm.dtype))
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def hidden_states(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor | None = None, mode: str = "train",
                  caches: list | None = None):
    """Returns (final-norm hidden states, summed MoE aux loss, caches)."""
    B, Sq = tokens.shape
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, Sq)
    x = L.embed(params.embed, tokens, cfg.compute_dtype) * cfg.embed_scale
    x, aux, caches = T.decoder_stack(params.layers, cfg, x, positions, mode=mode,
                                     caches=caches)
    return L.rmsnorm(params.final_norm, x), aux, caches


def _logits(params: Model, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    table = params.embed if cfg.tie_embeddings else params.head
    logits = L.unembed(table, hidden, cfg.compute_dtype) * cfg.logit_scale
    if cfg.padded_vocab != cfg.vocab_size:   # mask pad columns out of softmax
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: torch.device | str) -> list:
    """Per layer: ``{"ssm": {"conv", "ssd"}}`` (SSM family) or
    ``{"attn": {"k", "v", "pos"}}``."""
    if cfg.family == "ssm":
        return [{"ssm": S.init_ssm_state(cfg, batch, device)}
                for _ in range(cfg.num_layers)]
    return [{"attn": L.init_attn_cache(cfg, i, batch, max_len, device)}
            for i in range(cfg.num_layers)]


def prefill(params: Model, cfg: ModelConfig, batch: dict, max_len: int):
    """Process the prompt; returns (last-token logits, caches, next_pos)."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    caches = init_caches(cfg, B, max_len, tokens.device)
    h, _, caches = hidden_states(params, cfg, tokens, mode="prefill", caches=caches)
    logits = _logits(params, cfg, h[:, -1:])
    return logits, caches, torch.full((B,), Sq, dtype=torch.int32, device=tokens.device)


def decode_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, caches: list):
    """One token per sequence: tokens (B, 1), pos (B,). Returns
    (logits (B, 1, V), new_caches)."""
    h, _, caches = hidden_states(params, cfg, tokens, positions=pos[:, None],
                                 mode="decode", caches=caches)
    return _logits(params, cfg, h), caches


def greedy_decode(params: Model, cfg: ModelConfig, batch: dict, steps: int,
                  max_len: int) -> torch.Tensor:
    """Prefill then ``steps - 1`` greedy decode steps: (B, steps) int32 tokens."""
    logits, caches, pos = prefill(params, cfg, batch, max_len)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    outs = [tok]
    for _ in range(steps - 1):
        logits, caches = decode_step(params, cfg, tok[:, None], pos, caches)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        pos = pos + 1
        outs.append(tok)
    return torch.stack(outs, dim=1)
