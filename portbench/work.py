"""Work of one kernel launch, from its shapes alone, and the card's peaks.

These count what a launch needs, whatever implements it: the operations and
bytes of one flash-attention or RMSNorm launch. A roofline share is the
least time the card could take over the time it took. The model-level
counts (a prefill's and a decode token's FLOPs, a decode step's bytes)
depend on the architecture and sit in its module, ``arch/<name>.py``.
"""
from __future__ import annotations

#: Published dense peaks of the card (data sheet, SXM, no sparsity): bfloat16
#: tensor-core FLOP/s and HBM bytes/s, at the 700 W limit.
PEAKS = {"NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes": 3.35e12}}


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


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
