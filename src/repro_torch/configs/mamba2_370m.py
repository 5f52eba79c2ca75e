"""Mamba2-370m (SSD, attention-free). [arXiv:2405.21060; unverified]

48L d_model=1024, ssm_state=128, headdim=64 (expand=2 -> d_inner=2048,
32 ssm heads), vocab=50280. No attention, no MLP (pure Mamba-2 stack).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,        # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=128,
    tie_embeddings=True,
    loss_chunk=2048,
)
