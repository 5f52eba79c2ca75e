"""MiniCPM-2B. [arXiv:2404.06395; hf]

40L d_model=2304 36H (MHA: kv=36) d_ff=5760 vocab=122753; llama-like
architecture with mu-parametrization scaling (scale_emb=12,
scale_depth=1.4 -> residual_scale = 1.4/sqrt(40)) and tied embeddings;
trained with the WSD schedule (see repro_torch.optim.schedule.wsd).
"""
import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logit_scale=1.0 / (2304 / 256),
    rope_theta=10000.0,
    loss_chunk=2048,
)
