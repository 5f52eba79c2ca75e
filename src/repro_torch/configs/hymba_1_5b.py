"""Hymba-1.5B (hybrid attention + mamba heads in parallel). [arXiv:2411.13676; hf]

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504, ssm_state=16,
vocab=32001. Each block runs attention heads and SSM heads in PARALLEL on
the same input and fuses (mean of per-path RMSNorm) — per the paper.
Sliding-window attention (w=1024) on all layers (the released model keeps
3 full-attention layers; we use SWA uniformly and note the deviation in
DESIGN.md) -> sub-quadratic, long_500k applicable.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="sliding",
    window=1024,
    hybrid_ssm=True,
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=128,
    rope_theta=10000.0,
    loss_chunk=2048,
)
