"""Flash attention's share of its roofline (kernels layer): the least time
the card could take for the traced prefills' attention launches (``work.py``:
the pairs the causal mask keeps; q, k, v and o once) over the launches'
device time. A launch counts when it ran inside a prefill of the trace."""
from portbench import work

NAMES = ("fa_sm90", "fa_fwd_kernel")


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    m = r.model
    hd = work.head_dim(m)
    bound = took = 0.0
    for k in r.trace.kernels:
        if k.graph or not any(n in k.name for n in NAMES):
            continue
        s = r.prefill_at(k.start)
        if s is None:
            continue
        flops, nbytes = work.flash_attention_work(r.traffic["sequences"], s.req.length,
                                                  m["num_heads"], m["num_kv_heads"], hd)
        bound += work.roofline_seconds(flops, nbytes, r.peaks)
        took += k.end - k.start
    return 100.0 * bound / took if took else None
