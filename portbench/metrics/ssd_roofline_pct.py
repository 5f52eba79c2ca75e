"""The SSD intra-chunk kernel's share of its roofline (kernels layer): the
least time the card could take for the traced prefills' intra-chunk
launches over their device time.

A launch's work comes from its shapes, counted as the port's kernel table
counts it (:func:`launch_work`): the causal pairs of each chunk through
C·Bᵀ once a group and the outputs once a head, and each head's chunk-end
state; xs read and y written, b, c and the decays read, the states written
once, in float32. Its operations run as three TF32 products each (3xTF32),
at the card's TF32 peak, half its bfloat16 one. A launch counts when it
ran inside a prefill; the prefill's prompt, padded to whole chunks, gives
the sequence length.
"""
from portbench import work

NAMES = ("ssd_chunk_sm90_kernel", "ssd_chunk_kernel")


def launch_work(bh: int, bg: int, seq: int, chunk: int, p: int, n: int
                ) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``bh`` head rows (``bg`` group
    rows of b and c) of ``seq`` positions in chunks of ``chunk``."""
    nc = seq // chunk
    pairs = nc * chunk * (chunk + 1) // 2
    flops = 2 * pairs * (bg * n + bh * p) + 2 * bh * nc * chunk * n * p
    nbytes = 4 * (2 * bh * seq * p + 2 * bg * seq * n + bh * seq + bh * nc * (n * p + 1))
    return float(flops), float(nbytes)


def launch_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The larger of the bytes' bound and the 3xTF32 operations' bound."""
    return max(nbytes / peaks["bytes"], 3 * flops / (peaks["flops"] / 2))


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    m, B = r.model, r.traffic["sequences"]
    P, N, G = m["ssm_headdim"], m["ssm_state"], m["ssm_groups"]
    H = m["ssm_expand"] * m["d_model"] // P
    bound = took = 0.0
    for k in r.trace.kernels:
        if k.graph or not any(n in k.name for n in NAMES):
            continue
        s = r.prefill_at(k.start)
        if s is None:
            continue
        Q = min(m["ssm_chunk"], s.req.length)
        seq = -(-s.req.length // Q) * Q
        bound += launch_seconds(*launch_work(B * H, B * G, seq, Q, P, N), r.peaks)
        took += k.end - k.start
    return 100.0 * bound / took if took else None
