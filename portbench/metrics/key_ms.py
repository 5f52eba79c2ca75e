"""Host time spent keying a served step, per step (served-step layer): the
``submit.key`` spans (a request's buffer signature and coalescing key) and
the ``replay.key`` spans (a graph replay's flatten and graph key) that
ended in the window, over the ``step`` spans that ended in it."""
from portbench import program_spans as P


def read(r):
    recs = P.records(r)
    if recs is None:
        return None
    steps = P.ending_in_window(r, recs, "step")
    if not steps:
        return None
    keyed = sum(P.seconds(s) for name in ("submit.key", "replay.key")
                for s in P.ending_in_window(r, recs, name))
    return 1e3 * keyed / len(steps)
