"""Work counts of a dense decoder, from the configuration and the shapes alone.

These count what the model needs, whatever implements it: FLOPs of a
prefill and of a decode token, bytes a decode step must move, and the
operations and bytes of one flash-attention or RMSNorm launch. A roofline
share is the least time the card could take over the time it took.
"""
from __future__ import annotations

#: Published dense peaks of the card (data sheet, SXM, no sparsity): bfloat16
#: tensor-core FLOP/s and HBM bytes/s, at the 700 W limit.
PEAKS = {"NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes": 3.35e12}}

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def layer_matmul_params(m: dict) -> int:
    """Weights of one layer's products (attention and MLP)."""
    d, H, Hkv, hd, f = m["d_model"], m["num_heads"], m["num_kv_heads"], head_dim(m), m["d_ff"]
    attn = d * (H + 2 * Hkv) * hd + H * hd * d
    mlp = (3 if m["mlp"] == "swiglu" else 2) * d * f
    return attn + mlp


def param_count(m: dict) -> int:
    """Every weight the model holds: embedding, layers (norms, biases), head."""
    d, H, Hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], head_dim(m)
    per = layer_matmul_params(m) + 2 * d + ((H + 2 * Hkv) * hd if m["qkv_bias"] else 0)
    return 2 * m["padded_vocab"] * d + m["num_layers"] * per + d


def attn_flops(m: dict, pairs: float) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, in every layer and head."""
    return 4.0 * m["num_layers"] * m["num_heads"] * head_dim(m) * pairs


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    """A prefill of ``batch`` sequences of ``seq`` tokens that yields the
    first token: every layer on every position, causal pairs, the head on
    the last position."""
    per_seq = (2.0 * m["num_layers"] * layer_matmul_params(m) * seq
               + attn_flops(m, seq * (seq + 1) / 2)
               + 2.0 * m["vocab_size"] * m["d_model"])
    return batch * per_seq


def decode_flops(m: dict, ctx: int) -> float:
    """One decode token that attends to ``ctx`` positions (itself included)."""
    return (2.0 * m["num_layers"] * layer_matmul_params(m) + attn_flops(m, ctx)
            + 2.0 * m["vocab_size"] * m["d_model"])


def kv_bytes_per_token(m: dict) -> int:
    """One position's cached K and V over all layers, at the compute dtype."""
    return m["num_layers"] * 2 * m["num_kv_heads"] * head_dim(m) * _BYTES[m["dtype"]]


def step_param_bytes(m: dict, sequences: int) -> int:
    """A decode step reads each parameter once at its dtype, and only the
    embedding rows of its ``sequences`` tokens."""
    p = _BYTES[m["param_dtype"]]
    return (param_count(m) - m["padded_vocab"] * m["d_model"]) * p \
        + sequences * m["d_model"] * p


def token_cache_bytes(m: dict, ctx: int) -> int:
    """A decode token reads the ``ctx`` live cache entries and writes its own."""
    return (ctx + 1) * kv_bytes_per_token(m)


def flash_attention_work(batch: int, seq: int, heads: int, kv_heads: int, hd: int,
                         elem_bytes: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal self-attention launch over ``seq``
    positions: the pairs the causal mask keeps; q, k, v read and o written once."""
    pairs = seq * (seq + 1) / 2
    flops = 4.0 * batch * heads * hd * pairs
    nbytes = batch * seq * hd * (2 * heads + 2 * kv_heads) * elem_bytes
    return flops, float(nbytes)


def rmsnorm_work(rows: int, d: int, x_bytes: int = 2, w_bytes: int = 4) -> tuple[float, float]:
    """(FLOPs, bytes) of one RMSNorm launch: square, sum, scale by the root
    and by the weight (4 a value); x read and y written once, the weight once."""
    return 4.0 * rows * d, float(2 * rows * d * x_bytes + d * w_bytes)


def roofline_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peaks["flops"], nbytes / peaks["bytes"])
