"""Memory-bandwidth utilisation of decode (model layer): the bytes the
window's decode steps must move at the configuration's dtypes (each
parameter once a step, each live cache entry read once and each new one
written once a token), over the card's HBM peak times the window."""
from portbench import harness, work


def read(r):
    if r.peaks is None:
        return None
    B = r.traffic["sequences"]
    nbytes = sum(work.step_param_bytes(r.model, s["occupancy"] * B)
                 for s in harness.steps_in_window(r.win))
    for _, n, ctx, _, _ in harness.token_events(r.win, B):
        if ctx is not None:
            nbytes += n * work.token_cache_bytes(r.model, ctx)
    return 100.0 * nbytes / (r.peaks["bytes"] * r.win.seconds)
