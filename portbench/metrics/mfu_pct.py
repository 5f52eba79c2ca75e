"""Model FLOPs utilisation (model layer): the FLOPs the model needs for the
tokens prefilled and generated in the window (``work.py``, from the
configuration and the served shapes), over the card's bfloat16 peak times
the window."""
from portbench import harness, work


def read(r):
    if r.peaks is None:
        return None
    flops = 0.0
    for _, n, ctx, _, s in harness.token_events(r.win, r.traffic["sequences"]):
        flops += (work.prefill_flops(r.model, n, s.req.length) if ctx is None
                  else n * work.decode_flops(r.model, ctx))
    return 100.0 * flops / (r.peaks["flops"] * r.win.seconds)
