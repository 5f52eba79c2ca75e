"""Mean occupancy of the server's steps in the window (server layer): the
trace ring's ``occupancy``, the clients one replay carried."""
from portbench import harness


def read(r):
    steps = harness.steps_in_window(r.win)
    return sum(s["occupancy"] for s in steps) / len(steps) if steps else None
