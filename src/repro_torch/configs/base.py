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

    def _block_params(self, experts: int) -> int:
        if self.family == "ssm":
            return self.ssm_params()
        p = self.attn_params()
        if self.hybrid_ssm:
            p += self.ssm_params()
        if self.num_experts:
            p += experts * self.mlp_params(self.expert_d_ff)
            p += self.d_model * self.num_experts          # router
        else:
            p += self.mlp_params(self.d_ff)
        return p

    def block_params(self) -> int:
        """Parameters of one decoder block (norms and biases excluded)."""
        return self._block_params(self.num_experts + self.num_shared_experts)

    def active_block_params(self) -> int:
        """A block's parameters that one token uses (top-k + shared experts)."""
        return self._block_params(self.top_k + self.num_shared_experts)

    def _param_count(self, block: int) -> int:
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        body = self.num_layers * block
        if self.encoder_layers:
            body += self.encoder_layers * (self.attn_params() + self.mlp_params(self.d_ff))
            body += self.num_layers * self.attn_params()  # cross-attention
        return emb + body

    def param_count(self) -> int:
        return self._param_count(self.block_params())

    def active_param_count(self) -> int:
        return self._param_count(self.active_block_params())

    def model_flops_per_token(self, seq_len: int, training: bool = True,
                              decode: bool = False) -> float:
        """6·N_active (training; 2·N_active otherwise) plus the attention
        O(S·d) term and the SSD state term, as the reference counts them.
        ``decode``: one token against a seq_len-long context."""
        mult = 6.0 if training else 2.0
        flops = mult * self.active_param_count()
        if self.family != "ssm":
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
            flops += (mult / 2) * self.num_layers * att
        if self.family == "ssm" or self.hybrid_ssm:
            # SSD state update + readout per token ~ 6 * d_inner * N
            flops += (mult / 2) * self.num_layers * 6.0 * self.ssm_inner * self.ssm_state
        return flops


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
