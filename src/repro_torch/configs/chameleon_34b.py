"""Chameleon-34B (early-fusion VLM). [arXiv:2405.09818; unverified]

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. Early fusion:
image patches arrive as VQ token ids in the SAME token stream (the VQ-GAN
tokenizer is a STUB — ``input_specs`` provides token ids directly).
QK-norm per the paper's training-stability recipe.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    rope_theta=10000.0,
    loss_chunk=2048,
)
