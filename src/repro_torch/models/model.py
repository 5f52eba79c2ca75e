"""Model API: init / forward / loss (training) and prefill / decode (serving).

Port of ``repro.models.model`` for every family (Whisper's encoder runs
over stub frame embeddings, ``batch["frames"]``, as in the reference). The
decode step is the payload that the taskgraph runtime records and replays:
shape stable and free of side effects (caches are returned, never written
in place), so one step can be ``torch.func.vmap``-ed across tenants.

Two views of one set of weights. A :class:`Model` holds them as modules
(serving's form; no gradients). Training takes them as a flat dict of
tensors keyed by the module paths (``params_of``): ``"embed.table"``,
``"layers.3.attn.wq.w"``, ... — the reference's pytree with the stacked
``L`` axis unrolled into the path. :func:`bind` turns such a dict into an
attribute view of the same shape as a ``Model`` (no copy, no module
state), so every apply function runs on it and autograd sees the dict's
tensors; :func:`model_of` goes back to a ``Model`` sharing their storage.
"""
from __future__ import annotations

import contextlib
import functools
import types
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.spans import span
from . import layers as L
from . import moe as MoE
from . import ssm as S
from . import transformer as T


class Model(nn.Module):
    """Parameter tree of the reference (``embed``, ``layers``, ``final_norm``,
    ``head`` when untied, ``encoder`` and ``enc_norm`` for encdec); the layer
    index is the ModuleList index where the reference stacks a leading ``L``
    axis. Entries are uninitialized until
    :func:`init_params` or :func:`params_from_jax` fills them. ``device``
    is required: the model is built where the caller says, never on a
    default device."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str):
        super().__init__()
        dt = cfg.param_torch_dtype
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(T.Block(cfg, device, i) for i in range(cfg.num_layers))
        self.final_norm = T.norm_module(cfg, cfg.d_model, device)
        self.head = (None if cfg.tie_embeddings
                     else L.Embedding(cfg.padded_vocab, cfg.d_model, dt, device))
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(T.EncoderBlock(cfg, device)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = T.norm_module(cfg, cfg.d_model, device)


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


def flatten_jax(np_tree: Mapping[str, Any], cfg: ModelConfig) -> dict[str, np.ndarray]:
    """A tree of the reference's parameter structure (params, or AdamW's
    ``mu`` / ``nu``) as numpy arrays -> {port name: array}.

    The decoder's and the encoder's layers are stacked on a leading ``L``
    axis in JAX: ``layers.3.attn.wq.w`` takes
    ``np_tree["layers"]["attn"]["wq"]["w"][3]`` and ``encoder.1.mlp.up.w``
    ``np_tree["encoder"]["mlp"]["up"]["w"][1]``; every other name is its
    path in the tree (``enc_norm.bias``, ``layers.*.cross.wk.b``,
    ``layers.*.ssm.x_proj.w``, ``layers.*.attn_out_norm.scale``, ...).
    """
    out = {}
    for name, prm in _skeleton(cfg).named_parameters():
        path = name.split(".")
        layer = None
        if path[0] in ("layers", "encoder"):
            layer, path = int(path[1]), [path[0]] + path[2:]
        node = np_tree
        for key in path:
            node = node[key]
        arr = np.asarray(node if layer is None else node[layer])
        if arr.shape != tuple(prm.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != {tuple(prm.shape)}")
        out[name] = arr
    return out


def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig,
                    device: torch.device | str) -> Model:
    """The port's model holding the reference's parameter pytree (numpy
    arrays, layers stacked; see :func:`flatten_jax`), on ``device``."""
    model = Model(cfg, device)
    flat = flatten_jax(np_params, cfg)
    for name, prm in model.named_parameters():
        prm.copy_(torch.from_numpy(flat[name].astype(np.float32)).to(prm.dtype))
    return model


def opt_state_from_jax(np_state: Mapping[str, Any], cfg: ModelConfig,
                       device: torch.device | str) -> dict:
    """The reference's AdamW state (``mu``, ``nu`` over the params tree,
    ``step``) as numpy arrays -> the port's: ``mu`` / ``nu`` as f32 dicts
    keyed like :func:`params_of`, ``step`` a 0-dim int32 tensor, all on
    ``device``."""
    state = {k: {n: torch.from_numpy(np.array(a, np.float32)).to(device)
                 for n, a in flatten_jax(np_state[k], cfg).items()}
             for k in ("mu", "nu")}
    state["step"] = torch.tensor(int(np.asarray(np_state["step"])), dtype=torch.int32,
                                 device=device)
    return state


# ---------------------------------------------------------------------------
# The functional view: name -> tensor dicts
# ---------------------------------------------------------------------------

@functools.cache
def _skeleton(cfg: ModelConfig) -> Model:
    """The module tree of ``cfg`` on the meta device (names and shapes only)."""
    return Model(cfg, "meta")


def params_of(model: Model) -> dict[str, torch.Tensor]:
    """The model's weights as {module path: tensor}, sharing their storage."""
    return {name: p.detach() for name, p in model.named_parameters()}


def model_of(cfg: ModelConfig, params: Mapping[str, torch.Tensor]) -> Model:
    """A :class:`Model` whose parameters share ``params``' storage."""
    model = Model(cfg, "meta")
    for name, mod in list(model.named_modules()):
        for pname, prm in list(mod._parameters.items()):
            if prm is not None:
                key = f"{name}.{pname}" if name else pname
                mod._parameters[pname] = nn.Parameter(params[key], requires_grad=False)
    return model


def _bind_module(mod: nn.Module, params: Mapping[str, torch.Tensor], prefix: str):
    if isinstance(mod, nn.ModuleList):
        return [_bind_module(m, params, f"{prefix}{i}.") for i, m in enumerate(mod)]
    view = types.SimpleNamespace(**{k: None for k, v in vars(mod).items()
                                    if v is None and not k.startswith("_")})
    for name, prm in mod._parameters.items():
        setattr(view, name, None if prm is None else params[prefix + name])
    for name, sub in mod._modules.items():
        setattr(view, name, None if sub is None else _bind_module(sub, params, f"{prefix}{name}."))
    return view


def bind(cfg: ModelConfig, params: Mapping[str, torch.Tensor], layer: int | None = None):
    """An attribute view of ``params`` (keyed as :func:`params_of`) shaped
    like a :class:`Model` (or, with ``layer``, like its block ``layer``,
    read from the keys ``layers.{layer}.*``): the apply functions run on it
    as on the modules, with the dict's tensors. Builds Python objects only."""
    skel = _skeleton(cfg)
    if layer is None:
        return _bind_module(skel, params, "")
    return _bind_module(skel.layers[layer], params, f"layers.{layer}.")


def param_count(params) -> int:
    """Number of weights of a :class:`Model` or a name -> tensor dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(t.numel() for t in tensors)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def encode(params: Model, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, Se, d): sinusoidal
    positions, the encoder blocks, the encoder's final norm."""
    x = frames.to(cfg.compute_dtype)
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    x = T.encoder_stack(params.encoder, cfg, x)
    return T.norm(cfg, params.enc_norm, x)


def _enc_out(params: Model, cfg: ModelConfig, batch: dict) -> torch.Tensor | None:
    return encode(params, cfg, batch["frames"]) if cfg.family == "encdec" else None


def hidden_states(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor | None = None,
                  enc_out: torch.Tensor | None = None, mode: str = "train",
                  caches: list | None = None):
    """Returns (final-norm hidden states, summed MoE aux loss, caches)."""
    B, Sq = tokens.shape
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, Sq)
    x = L.embed(params.embed, tokens, cfg.compute_dtype) * cfg.embed_scale
    if cfg.family == "encdec" and cfg.rope_theta <= 0:
        # absolute sinusoidal positions at the (possibly decode) positions
        x = x + L.sinusoidal_at(positions, cfg.d_model).to(x.dtype)
    x, aux, caches = T.decoder_stack(params.layers, cfg, x, positions, mode=mode,
                                     caches=caches, enc_out=enc_out)
    return T.norm(cfg, params.final_norm, x), aux, caches


def _logits(params: Model, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    table = params.embed if cfg.tie_embeddings else params.head
    logits = L.unembed(table, hidden, cfg.compute_dtype) * cfg.logit_scale
    if cfg.padded_vocab != cfg.vocab_size:   # mask pad columns out of softmax
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits


def forward(params: Model, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full logits (B, S, V) and the MoE aux loss; use :func:`loss_fn` for
    training (chunked CE). encdec reads ``batch["frames"]`` (B, Se, d)."""
    h, aux, _ = hidden_states(params, cfg, batch["tokens"],
                              enc_out=_enc_out(params, cfg, batch))
    return _logits(params, cfg, h), aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _ce_chunk(params, cfg: ModelConfig, hidden, labels, mask):
    logits = _logits(params, cfg, hidden)                 # (B, s, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (lse - gold) * mask
    return ce.sum(), mask.sum()


def shifted_labels(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token labels (the sequence rotated left by one) and the mask that
    drops the last position, as the reference builds them."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def loss_labels(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The labels :func:`loss_fn` scores and its mask (the last position
    dropped, times ``batch["loss_mask"]`` when given); the mask's sum is the
    token count ``loss_fn`` reports."""
    labels, mask = shifted_labels(batch["tokens"])
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].float()
    return labels, mask


def loss_fn(params: Model, cfg: ModelConfig, batch: dict):
    """Next-token CE (+ MoE aux) -> (loss, {loss, ce, aux, tokens}).

    ``params`` is a :class:`Model` or a :func:`bind` view. Big-vocab safe:
    with ``cfg.loss_chunk`` dividing S (and below it), CE runs over sequence
    chunks whose logits are recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so the
    full logits never exist at once. ``batch["loss_mask"]`` (optional)
    multiplies the mask; encdec reads ``batch["frames"]``.
    """
    tokens = batch["tokens"]
    h, aux, _ = hidden_states(params, cfg, tokens, enc_out=_enc_out(params, cfg, batch))
    labels, mask = loss_labels(batch)

    Sq = tokens.shape[1]
    chunk = cfg.loss_chunk
    if chunk and Sq % chunk == 0 and Sq > chunk:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(Sq // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            s, n = checkpoint(_ce_chunk, params, cfg, h[:, sl], labels[:, sl], mask[:, sl],
                              use_reentrant=False, preserve_rng_state=False)
            tot, cnt = tot + s, cnt + n
    else:
        tot, cnt = _ce_chunk(params, cfg, h, labels, mask)
    ce = tot / torch.clamp(cnt, min=1.0)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: torch.device | str) -> list:
    """Per layer: ``{"ssm": {"conv", "ssd"}}`` (a Mamba-2 layer: the SSM
    family, or a layer ``layer_types`` says is one) or ``{"attn": {"k", "v",
    "pos"}}``, with ``"ssm"`` beside it for Hymba's hybrid and ``"cross_kv":
    {"k", "v"}`` (B, encoder_seq, Hkv, hd) for encdec."""
    caches = []
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "mamba":
            caches.append({"ssm": S.init_ssm_state(cfg, batch, device)})
            continue
        c = {"attn": L.init_attn_cache(cfg, i, batch, max_len, device)}
        if cfg.hybrid_ssm:
            c["ssm"] = S.init_ssm_state(cfg, batch, device)
        if cfg.family == "encdec":
            shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
            c["cross_kv"] = {k: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
                             for k in ("k", "v")}
        caches.append(c)
    return caches


def state_bytes(caches: list) -> dict:
    """Bytes of each kind of per-layer state in ``caches``: ``ssm_bytes``
    (conv history and SSD state) and ``kv_bytes`` (the attention ring's K,
    V and slot positions)."""
    def kind(name):
        return sum(t.nbytes for c in caches if name in c for t in c[name].values())
    return {"ssm_bytes": kind("ssm"), "kv_bytes": kind("attn")}


def prefill(params: Model, cfg: ModelConfig, batch: dict, max_len: int):
    """Process the prompt (and, for encdec, ``batch["frames"]``); returns
    (last-token logits, caches, next_pos). Its ``prefill`` span times the
    host's enqueue of the work, not the card's, except while spans record
    on a MoE model: ``prefill.moe`` then reads each layer's routed rows
    (``routed``) beside the rows its grouped products computed (``rows``)
    at the end, which waits for the card. ``prefill.caches`` carries the
    state built for the batch (:func:`state_bytes`) while recording."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    with span("prefill", batch=B, length=Sq) as recording:
        with span("prefill.caches") as sc:
            caches = init_caches(cfg, B, max_len, tokens.device)
            if sc:
                sc.set(**state_bytes(caches))
        counting = recording and cfg.num_experts
        with MoE.tally() if counting else contextlib.nullcontext() as counts:
            h, _, caches = hidden_states(params, cfg, tokens,
                                         enc_out=_enc_out(params, cfg, batch),
                                         mode="prefill", caches=caches)
        logits = _logits(params, cfg, h[:, -1:])
        if counts:
            with span("prefill.moe") as sm:
                sm.set(routed=torch.stack([r for r, _ in counts]).tolist(),
                       rows=[n for _, n in counts])
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
