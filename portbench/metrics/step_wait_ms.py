"""Mean time a served step blocks on the card (served-step layer): the
``step.wait`` spans that ended in the window, each the server waiting for
its step's outputs to be ready after the replay was queued."""
from portbench import program_spans as P


def read(r):
    recs = P.records(r)
    if recs is None:
        return None
    waits = P.ending_in_window(r, recs, "step.wait")
    return 1e3 * sum(P.seconds(s) for s in waits) / len(waits) if waits else None
