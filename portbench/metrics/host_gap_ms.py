"""Mean host time between two served steps (server layer): on the
scheduler's thread, from one ``step`` span's end to the next one's start,
over consecutive steps that both ended in the window (settling the last
step, its clients' callbacks and next submissions, picking the next)."""
from portbench import program_spans as P


def read(r):
    recs = P.records(r)
    if recs is None:
        return None
    by_thread: dict[str, list] = {}
    for s in P.ending_in_window(r, recs, "step"):
        by_thread.setdefault(s["thread"], []).append(s)
    gaps = [b["t0"] - a["t1"] for steps in by_thread.values()
            for a, b in zip(steps, steps[1:])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
