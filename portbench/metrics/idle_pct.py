"""Share of the traced window with nothing running on the card (device
layer), from the profiler's device timeline."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
