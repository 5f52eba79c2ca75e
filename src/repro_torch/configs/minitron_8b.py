"""Minitron-8B (pruned Nemotron-4). [arXiv:2407.14679; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000; Nemotron-style
squared-ReLU MLP (no gating).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    mlp="relu2",
    rope_theta=10000.0,
    loss_chunk=2048,
)
