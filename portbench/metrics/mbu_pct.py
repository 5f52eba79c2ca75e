"""Memory-bandwidth utilisation of decode (model layer): the bytes the
window's decode steps must move at the configuration's dtypes (the cell's
architecture module, ``arch/<name>.py``: each parameter a step reads once,
each live cache entry read once and each new one written once a token),
over the card's HBM peak times the window."""
from portbench import harness


def read(r):
    if r.peaks is None:
        return None
    arch = r.cell.arch
    B = r.traffic["sequences"]
    nbytes = sum(arch.step_param_bytes(r.model, s["occupancy"] * B)
                 for s in harness.steps_in_window(r.win))
    for _, n, ctx, _, _ in harness.token_events(r.win, B):
        if ctx is not None:
            nbytes += n * arch.token_cache_bytes(r.model, ctx)
    return 100.0 * nbytes / (r.peaks["bytes"] * r.win.seconds)
