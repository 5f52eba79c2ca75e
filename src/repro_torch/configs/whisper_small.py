"""Whisper-small (encoder-decoder). [arXiv:2212.04356; unverified]

12L encoder + 12L decoder, d_model=768 12H (MHA) d_ff=3072 GELU,
vocab=51865. The conv frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings (B, 1500, d). Assigned shapes apply to the
decoder; the encoder keeps Whisper's native 1500 frames.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp="gelu",
    encoder_layers=12,
    encoder_seq=1500,
    rope_theta=0.0,      # whisper uses absolute (sinusoidal) positions
    loss_chunk=2048,
)
