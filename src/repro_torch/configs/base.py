"""Model and input-shape configuration (port of ``repro.configs.base``): the
fields the ported families use (dense, MoE, SSM, hybrid, encoder-decoder
and VLM; swiglu, gelu and relu² MLPs), the training knobs ``remat`` and
``loss_chunk``, the decode knob ``shard_kv_seq``, the derived counts
(parameters, per-token FLOPs) with the reference's formulas, and the four
assigned shapes (:data:`SHAPES`). The reference's ``scan_layers`` (a
``lax.scan`` over stacked layers) has no field: every layer of the port is
unrolled.

Configs are plain frozen dataclasses, as in the reference. Dtypes are kept
as names (``"bfloat16"``, ``"float32"``) so a config stays hashable and
printable; :attr:`ModelConfig.compute_dtype` and
:attr:`ModelConfig.param_torch_dtype` give the torch dtypes.

The fields in :data:`PORT_FIELDS` are the port's own, for configurations the
port alone serves (Granite 4.0-H: Mamba-2 and attention layers by kind, a
chip's share of the experts); every reference architecture leaves them at
their defaults, so its counts are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 -> d_model // num_heads

    # attention flavor
    attention: Literal["full", "sliding", "chunked"] = "full"
    attn_scale: float = 0.0                 # softmax scale (0 -> head_dim ** -0.5)
    window: int = 0                         # sliding-window size
    attn_chunk: int = 0                     # chunked-local chunk size
    global_attn_every: int = 0              # every k-th layer is full attn
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0              # GLM partial rotary

    # MLP
    mlp: Literal["swiglu", "gelu", "relu2"] = "swiglu"

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                       # per-expert hidden (0 -> d_ff)
    num_shared_experts: int = 0
    shared_d_ff: int = 0                    # shared-expert hidden (0 -> expert_d_ff)
    experts_held: int = 0                   # experts this chip holds (0 -> all); the
    expert_offset: int = 0                  # router still scores num_experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "gspmd"                 # "gspmd" | "shard_map" (expert-parallel
    #                                         under a use_mesh scope with a "model" axis)

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_split_proj: bool = False            # separate z/x/B/C/dt projections
    shard_kv_seq: bool = False              # decode: shard cache length over
    #                                         "model" (MHA-style archs)

    # hybrid (Hymba): SSM runs in parallel with attention inside each block
    hybrid_ssm: bool = False
    # hybrid by layer (Granite 4.0-H): each layer's mixer, "mamba" or
    # "attention", in order; () -> the family's one kind in every layer
    layer_types: tuple = ()

    # encoder-decoder (Whisper): stub conv frontend supplies frame embeddings
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # embeddings / scaling (MiniCPM mu-parametrization)
    tie_embeddings: bool = False
    embed_scale: float = 1.0
    residual_scale: float = 1.0             # applied per-block output
    logit_scale: float = 1.0

    # numerics
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "float32"
    attn_q_chunk: int = 2048                # q-chunking of full attention (plain path)

    # training
    remat: Literal["none", "full", "dots"] = "full"   # per-block recompute
    loss_chunk: int = 0                     # CE in chunks of tokens (0 = off)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        # a list (a configuration read from JSON) is kept as a tuple: hashable
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.layer_types and len(self.layer_types) != self.num_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"{self.num_layers} layers")
        if set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"layer_types takes 'mamba' and 'attention'; got "
                             f"{sorted(set(self.layer_types))}")
        if self.experts_held and not (
                0 <= self.expert_offset
                and self.expert_offset + self.experts_held <= self.num_experts):
            raise ValueError(f"experts {self.expert_offset}..."
                             f"{self.expert_offset + self.experts_held - 1} held of "
                             f"{self.num_experts}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as in the reference."""
        mult = 256
        return (self.vocab_size + mult - 1) // mult * mult

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def shared_expert_d_ff(self) -> int:
        return self.shared_d_ff or self.expert_d_ff

    @property
    def held_experts(self) -> int:
        """Routed experts whose weights this model holds."""
        return self.experts_held or self.num_experts

    def layer_kind(self, i: int) -> str:
        """Layer ``i``'s mixer: "mamba" (the SSM family, or ``layer_types``
        says so) or "attention" (with the SSM beside it when ``hybrid_ssm``)."""
        if self.layer_types:
            return self.layer_types[i]
        return "mamba" if self.family == "ssm" else "attention"

    def _kind_count(self, kind: str) -> int:
        return sum(self.layer_kind(i) == kind for i in range(self.num_layers))

    # ---- derived counts (the reference's formulas) -------------------------
    def mlp_params(self, d_ff: int) -> int:
        per = 3 if self.mlp == "swiglu" else 2
        return per * self.d_model * d_ff

    def attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d

    def ssm_params(self) -> int:
        di, n, g = self.ssm_inner, self.ssm_state, self.ssm_groups
        in_proj = self.d_model * (2 * di + 2 * g * n + self.ssm_heads)
        out_proj = di * self.d_model
        conv = self.ssm_conv * (di + 2 * g * n)
        return in_proj + out_proj + conv + 2 * self.ssm_heads

    def _block_params(self, experts, layer: int = 0):
        """Layer ``layer``'s parameters when ``experts`` routed experts count."""
        if self.layer_kind(layer) == "mamba":
            p = self.ssm_params()
            if self.family == "ssm":
                return p                                  # a pure Mamba-2 stack
        else:
            p = self.attn_params()
            if self.hybrid_ssm:
                p += self.ssm_params()
        if self.num_experts:
            p += experts * self.mlp_params(self.expert_d_ff)
            p += self.num_shared_experts * self.mlp_params(self.shared_expert_d_ff)
            p += self.d_model * self.num_experts          # router
        else:
            p += self.mlp_params(self.d_ff)
        return p

    def block_params(self, layer: int = 0) -> int:
        """Parameters of decoder block ``layer`` (norms and biases excluded):
        its held experts, every shared one and the router."""
        return self._block_params(self.held_experts, layer)

    def _active_experts(self):
        """Routed experts a token uses here: top-k, or where this chip holds a
        share, the held share of them on average (k · held / E)."""
        if self.held_experts == self.num_experts:
            return self.top_k
        return self.top_k * self.held_experts / self.num_experts

    def active_block_params(self, layer: int = 0):
        """Block ``layer``'s parameters that one token uses (its routed
        experts and the shared ones)."""
        return self._block_params(self._active_experts(), layer)

    def _param_count(self, block) -> int:
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        body = sum(block(i) for i in range(self.num_layers))
        if self.encoder_layers:
            body += self.encoder_layers * (self.attn_params() + self.mlp_params(self.d_ff))
            body += self.num_layers * self.attn_params()  # cross-attention
        return emb + body

    def param_count(self) -> int:
        return self._param_count(self.block_params)

    def active_param_count(self):
        return self._param_count(self.active_block_params)

    def model_flops_per_token(self, seq_len: int, training: bool = True,
                              decode: bool = False) -> float:
        """6·N_active (training; 2·N_active otherwise) plus the attention
        O(S·d) term and the SSD state term, as the reference counts them.
        ``decode``: one token against a seq_len-long context."""
        mult = 6.0 if training else 2.0
        flops = mult * self.active_param_count()
        if self._kind_count("attention"):
            if decode:
                eff = seq_len
                if self.attention == "sliding" and self.window:
                    eff = min(eff, self.window)
                if self.attention == "chunked" and self.attn_chunk:
                    eff = min(eff, self.attn_chunk)
            else:
                eff = seq_len / 2  # causal average
                if self.attention == "sliding" and self.window:
                    eff = min(eff, self.window)
                if self.attention == "chunked" and self.attn_chunk:
                    eff = min(eff, self.attn_chunk / 2)
            # qk^T and pv matmuls: 2 * 2 * H * hd * eff each fwd
            att = 4.0 * self.num_heads * self.head_dim * eff
            flops += (mult / 2) * self._kind_count("attention") * att
        ssm_layers = self.num_layers if self.hybrid_ssm else self._kind_count("mamba")
        if ssm_layers:
            # SSD state update + readout per token ~ 6 * d_inner * N
            flops += (mult / 2) * ssm_layers * 6.0 * self.ssm_inner * self.ssm_state
        return flops


#: The fields the port has and the reference lacks; every reference
#: architecture leaves them at their defaults.
PORT_FIELDS = frozenset({"attn_scale", "shared_d_ff", "experts_held", "expert_offset",
                         "layer_types"})


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch           # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(config: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell is assigned: long_500k only for
    subquadratic archs (SSM, hybrid, sliding window)."""
    if shape.name == "long_500k":
        subquadratic = (config.family == "ssm"
                        or config.hybrid_ssm
                        or (config.attention == "sliding" and config.window > 0))
        if not subquadratic:
            return False, "full-attention arch: long_500k skipped (quadratic)"
    return True, ""


def reduced(config: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (the reference's sizes)."""
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(config.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window=min(config.window, 32) if config.window else 0,
        attn_chunk=min(config.attn_chunk, 32) if config.attn_chunk else 0,
        num_experts=min(config.num_experts, 4),
        top_k=min(config.top_k, 2),
        moe_d_ff=96 if config.num_experts else 0,
        # drop-free capacity: keeps smoke tests deterministic across
        # different token counts (prefill vs teacher-forced forward)
        capacity_factor=4.0,
        ssm_state=min(config.ssm_state, 16) if config.ssm_state else 0,
        ssm_headdim=16,
        ssm_chunk=16,
        encoder_layers=2 if config.encoder_layers else 0,
        encoder_seq=24 if config.encoder_layers else 1500,
        remat="none",
        dtype="float32",
        loss_chunk=0,
        name=config.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(config, **small)
