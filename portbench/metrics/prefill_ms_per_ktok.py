"""Prefill time per 1,000 prompt tokens (prefill layer): the client's clock
from the prefill call to its first token being ready, over the prompt
tokens of the call, as a mean over the window's prefills."""
from portbench import harness


def read(r):
    B = r.traffic["sequences"]
    per = [(t1 - t0) * 1e3 / (B * s.req.length / 1e3)
           for t0, t1, s in harness.prefills_in(r.win) if r.win.inside(t1)]
    return sum(per) / len(per) if per else None
