"""Granite 4.0-H Small (32B-A9B), one chip's share of its experts.
[hf:ibm-granite/granite-4.0-h-small config.json, model_type granitemoehybrid]

40L d_model=4096 of two kinds (``layer_types``): 36 Mamba-2 mixers (128
heads of 64, d_state 128, 1 group, conv 4 with bias, expand 2, no
projection bias) and 4 attention layers at 5, 15, 25 and 35 (GQA 32/8
heads of 128, NoPE, scale ``attention_multiplier`` 1/128, no bias). Every
layer then has an MoE of 72 experts of width 768, top-10 (softmax over the
ten chosen logits), dropless, beside a shared SwiGLU of 1536. Embeddings
×12 and tied; residuals ×0.22 on both branches; logits ÷16; vocab 100352.

The deployment shares each layer's experts over 8 chips; this chip holds
experts 0–8 (9 of 72) of every layer, the router at its 72 outputs and
everything else whole: 8.43 B parameters. Departures: RMSNorm eps 1e-5 ->
the port's fixed 1e-6; the SSD blocked in chunks of 128, not 256 (the same
sum; the kernel's tile).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    layer_types=tuple("attention" if i % 10 == 5 else "mamba" for i in range(40)),
    attn_scale=0.0078125,
    rope_theta=0.0,
    num_experts=72,
    top_k=10,
    moe_d_ff=768,
    num_shared_experts=1,
    shared_d_ff=1536,
    experts_held=9,
    expert_offset=0,
    capacity_factor=72 / 10,    # E / k: an expert has room for every token, so dropless
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=0.22,
    logit_scale=1 / 16,
    loss_chunk=2048,
)
