"""Llama-4 Scout 17B-active / 16 experts (early-fusion MoE).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, 16e top-1,
one shared expert; iRoPE-style chunked-local attention with a full-attention
layer every 4 (global layers keep the TDG shape static; chunk=8192).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attention="chunked",
    attn_chunk=8192,
    global_attn_every=4,
    num_experts=16,
    top_k=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    rope_theta=500000.0,
    loss_chunk=2048,
)
