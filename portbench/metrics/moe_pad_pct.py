"""The share of the expert rows a prefill's grouped products computed that
no (token, choice) was routed to (model layer): 1 - routed / rows over the
MoE layers of the traced prefills, from the program's ``prefill.moe`` spans
(``routed``: rows sent to the experts a layer holds; ``rows``: the rows its
grouped products computed, the held experts times their capacity)."""
from portbench import program_spans as P


def read(r):
    recs = P.records(r)
    if recs is None:
        return None
    moe = [s["args"] for s in recs if s["name"] == "prefill.moe"]
    rows = sum(sum(a["rows"]) for a in moe)
    return 100.0 * (1 - sum(sum(a["routed"]) for a in moe) / rows) if rows else None
