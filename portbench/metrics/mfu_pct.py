"""Model FLOPs utilisation (model layer): the FLOPs the model needs for the
tokens prefilled and generated in the window (the cell's architecture
module, ``arch/<name>.py``, from the configuration and the served shapes),
over the card's bfloat16 peak times the window."""
from portbench import harness


def read(r):
    if r.peaks is None:
        return None
    arch = r.cell.arch
    flops = 0.0
    for _, n, ctx, _, s in harness.token_events(r.win, r.traffic["sequences"]):
        flops += (arch.prefill_flops(r.model, n, s.req.length) if ctx is None
                  else n * arch.decode_flops(r.model, ctx))
    return 100.0 * flops / (r.peaks["flops"] * r.win.seconds)
