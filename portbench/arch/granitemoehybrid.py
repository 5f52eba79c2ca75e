"""Granite 4.0-H (``granitemoehybrid``): its parameter layout and its
model-level work counts, for one chip's share of the experts.

Layers of two kinds by ``layer_types``: a Mamba-2 mixer or NoPE GQA
attention, each followed by an MoE (a router over all ``num_experts``, the
``experts_held`` experts this chip holds, one shared SwiGLU expert of
``shared_d_ff``). The embedding is tied to the head. What the module gives,
from the configuration's ``model`` block alone, is what ``arch/dense.py``
gives (its docstring); the counts cover the held share: a token's routed
work is the top-k choices that land on held experts, ``top_k * held / E``
of them on average, and the state a decode token reads and writes is of
both kinds, the attention layers' KV ring and the Mamba layers' conv and
SSD state.

It imports nothing of the program.
"""
from __future__ import annotations

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _dims(m: dict) -> dict:
    d, P, G, N = m["d_model"], m["ssm_headdim"], m["ssm_groups"], m["ssm_state"]
    di = m["ssm_expand"] * d
    H = di // P
    return dict(d=d, di=di, H=H, P=P, G=G, N=N, K=m["ssm_conv"], conv_ch=di + 2 * G * N,
                in_dim=2 * di + 2 * G * N + H, hd=m["head_dim"])


def _kinds(m: dict) -> tuple[int, int]:
    """(Mamba layers, attention layers)."""
    mamba = sum(k == "mamba" for k in m["layer_types"])
    return mamba, len(m["layer_types"]) - mamba


def layout(model: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, group) of every tensor; group names the distribution.
    The SSM's ``A_log`` and ``dt_bias`` are drawn as biases (near 0: A near
    -1) and ``D`` as a norm scale (near 1). The tied embedding is drawn at
    std 1 / (embed_scale · √d), so that the scaled rows entering the
    residual stream have the fan-in std of every other product's weights:
    at 1 / √d the tied head reads a token's own 12-fold embedding back, and
    every greedy token repeats its input, in any precision."""
    m = _dims(model)
    d, di, H, hd = m["d"], m["di"], m["H"], m["hd"]
    Hq, Hkv = model["num_heads"], model["num_kv_heads"]
    E, held, f, fs = (model["num_experts"], model["experts_held"], model["moe_d_ff"],
                      model["shared_d_ff"])
    emb = round(model["embed_scale"] ** 2 * d)
    out = [("embed.table", (model["padded_vocab"], d), f"w{emb}"),
           ("final_norm.scale", (d,), "norm")]
    for i, kind in enumerate(model["layer_types"]):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), "norm"), (p + "norm2.scale", (d,), "norm")]
        if kind == "mamba":
            s = p + "ssm."
            out += [(s + "A_log", (H,), "bias"), (s + "D", (H,), "norm"),
                    (s + "dt_bias", (H,), "bias"), (s + "norm.scale", (di,), "norm"),
                    (s + "in_proj.w", (d, m["in_dim"]), f"w{d}"),
                    (s + "out_proj.w", (di, d), f"w{di}"),
                    (s + "conv.w", (m["K"], m["conv_ch"]), f"w{m['K']}"),
                    (s + "conv.b", (m["conv_ch"],), "bias")]
        else:
            a = p + "attn."
            out += [(a + "wq.w", (d, Hq * hd), f"w{d}"), (a + "wk.w", (d, Hkv * hd), f"w{d}"),
                    (a + "wv.w", (d, Hkv * hd), f"w{d}"),
                    (a + "wo.w", (Hq * hd, d), f"w{Hq * hd}")]
        e = p + "moe."
        out += [(e + "router.w", (d, E), f"w{d}"),
                (e + "experts.up.w", (held, d, f), f"w{d}"),
                (e + "experts.gate.w", (held, d, f), f"w{d}"),
                (e + "experts.down.w", (held, f, d), f"w{f}"),
                (e + "shared0.up.w", (d, fs), f"w{d}"),
                (e + "shared0.gate.w", (d, fs), f"w{d}"),
                (e + "shared0.down.w", (fs, d), f"w{fs}")]
    return out


def param_count(m: dict) -> int:
    """Every weight this chip holds: the embedding (the head too), every
    layer's mixer, norms, router, held and shared experts."""
    total = 0
    for _, shape, _ in layout(m):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def _token_products(m: dict, routed: float) -> dict:
    """Product weights one token multiplies in a layer of each kind, with
    ``routed`` of its choices on held experts."""
    x = _dims(m)
    d, di, hd = x["d"], x["di"], x["hd"]
    ffn = routed * 3 * d * m["moe_d_ff"] + 3 * d * m["shared_d_ff"] + d * m["num_experts"]
    attn = d * (m["num_heads"] + 2 * m["num_kv_heads"]) * hd + m["num_heads"] * hd * d
    return {"mamba": d * x["in_dim"] + di * d + ffn, "attention": attn + ffn}


def routed_per_token(m: dict) -> float:
    """A token's choices that land on the held experts, on average."""
    return m["top_k"] * m["experts_held"] / m["num_experts"]


def _mamba_token_flops(m: dict) -> float:
    """The causal conv over one position and the SSD's state update and
    readout (~6 · d_inner · N, as the program's ModelConfig counts it)."""
    x = _dims(m)
    return 2.0 * x["K"] * x["conv_ch"] + 6.0 * x["di"] * x["N"]


def _per_token(m: dict) -> float:
    per = _token_products(m, routed_per_token(m))
    mamba, attn = _kinds(m)
    return (2.0 * (mamba * per["mamba"] + attn * per["attention"])
            + mamba * _mamba_token_flops(m))


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    """A prefill of ``batch`` sequences of ``seq`` tokens that yields the
    first token: every layer on every position (the routed rows of the held
    share), the attention layers' causal pairs, the head on the last
    position."""
    _, attn = _kinds(m)
    pairs = seq * (seq + 1) / 2
    return batch * (_per_token(m) * seq + 4.0 * attn * m["num_heads"] * m["head_dim"] * pairs
                    + 2.0 * m["vocab_size"] * m["d_model"])


def decode_flops(m: dict, ctx: int) -> float:
    """One decode token that attends to ``ctx`` positions (itself included)
    in the attention layers and steps the state of the Mamba layers."""
    _, attn = _kinds(m)
    return (_per_token(m) + 4.0 * attn * m["num_heads"] * m["head_dim"] * ctx
            + 2.0 * m["vocab_size"] * m["d_model"])


def step_param_bytes(m: dict, sequences: int) -> int:
    """A decode step reads each parameter once at its dtype (the tied table
    once, as the head), less the held experts no token chose: at most
    ``sequences * top_k`` of them a layer."""
    unused = max(0, m["experts_held"] - sequences * m["top_k"]) * 3 * m["d_model"] * m["moe_d_ff"]
    return _BYTES[m["param_dtype"]] * (param_count(m) - len(m["layer_types"]) * unused)


def token_cache_bytes(m: dict, ctx: int) -> int:
    """A decode token reads the ``ctx`` live KV entries of each attention
    layer and writes its own, and reads and writes each Mamba layer's conv
    history (compute dtype) and SSD state (float32)."""
    x = _dims(m)
    mamba, attn = _kinds(m)
    kv = (ctx + 1) * attn * 2 * m["num_kv_heads"] * x["hd"] * _BYTES[m["dtype"]]
    state = 2 * mamba * ((x["K"] - 1) * x["conv_ch"] * _BYTES[m["dtype"]]
                         + x["H"] * x["P"] * x["N"] * 4)
    return kv + state
