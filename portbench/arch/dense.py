"""A dense GQA decoder: its parameter layout and its model-level work counts.

A configuration file names its architecture (``"arch": "dense"``), and the
harness finds this module by that name, as it finds the reference. What an
architecture module gives, from the configuration's ``model`` block alone:

- ``layout(model)``: (name, shape, group) of every tensor, keyed as the
  program's parameter tree names them; the group names the distribution
  ``weights.fill`` draws it from (``w<fan_in>``, ``bias``, ``norm``).
- ``param_count``, ``prefill_flops``, ``decode_flops``, ``step_param_bytes``
  and ``token_cache_bytes``: what the model needs, whatever implements it,
  read by the model layer's metrics (``mfu_pct``, ``mbu_pct``).

It imports nothing of the program.
"""
from __future__ import annotations

from portbench.work import head_dim

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def layout(model: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, group) of every tensor; group names the distribution."""
    d, H, Hkv = model["d_model"], model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    f, V = model["d_ff"], model["padded_vocab"]
    out = [("embed.table", (V, d), f"w{d}"), ("head.table", (V, d), f"w{d}"),
           ("final_norm.scale", (d,), "norm")]
    for i in range(model["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), "norm"), (p + "norm2.scale", (d,), "norm"),
                (p + "attn.wq.w", (d, H * hd), f"w{d}"),
                (p + "attn.wk.w", (d, Hkv * hd), f"w{d}"),
                (p + "attn.wv.w", (d, Hkv * hd), f"w{d}"),
                (p + "attn.wo.w", (H * hd, d), f"w{H * hd}"),
                (p + "mlp.up.w", (d, f), f"w{d}"),
                (p + "mlp.down.w", (f, d), f"w{f}")]
        if model["mlp"] == "swiglu":
            out.append((p + "mlp.gate.w", (d, f), f"w{d}"))
        if model["qkv_bias"]:
            out += [(p + "attn.wq.b", (H * hd,), "bias"), (p + "attn.wk.b", (Hkv * hd,), "bias"),
                    (p + "attn.wv.b", (Hkv * hd,), "bias")]
    return out


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
