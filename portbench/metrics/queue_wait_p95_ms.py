"""95th percentile of the time a request waits in the server (server
layer): from its submission (the ``t0`` of the ``submit.key`` span that
carries its ``rid``) to the start of the first ``step`` span whose
``rids`` hold it, over the requests whose step began in the window."""
from portbench import harness
from portbench import program_spans as P


def read(r):
    recs = P.records(r)
    if recs is None:
        return None
    submitted = {s["args"]["rid"]: s["t0"] for s in recs
                 if s["name"] == "submit.key" and "rid" in s["args"]}
    seen: set = set()
    waits = []
    for s in sorted((s for s in recs if s["name"] == "step"), key=lambda s: s["t0"]):
        for rid in s["args"].get("rids", ()):
            if rid in seen:
                continue
            seen.add(rid)
            if rid in submitted and r.win.inside(s["t0"]):
                waits.append(s["t0"] - submitted[rid])
    return 1e3 * harness.nearest_rank(waits, 95) if waits else None
