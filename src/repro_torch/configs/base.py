"""Model configuration: the fields of ``repro.configs.base`` that the ported
families use (dense, MoE, SSM, hybrid, encoder-decoder and VLM; swiglu,
gelu and relu² MLPs) and the training knobs ``remat`` and ``loss_chunk``.

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
