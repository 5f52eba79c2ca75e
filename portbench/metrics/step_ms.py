"""Mean wall time of a served step in the window (served-step layer): the
trace ring's ``wall_ms``, from a step's start to its outputs being ready."""
from portbench import harness


def read(r):
    steps = harness.steps_in_window(r.win)
    return sum(s["wall_ms"] for s in steps) / len(steps) if steps else None
