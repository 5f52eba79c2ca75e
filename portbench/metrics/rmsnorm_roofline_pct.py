"""RMSNorm's share of its roofline (kernels layer): the least time the card
could take for the traced launches (``work.py``: x read and y written once in
the compute dtype, the weight once in the param dtype) over their device
time. A prefill's launch normalises its batch times its prompt rows; a
served step's, inside the step's graph, its bucket times the request's rows."""
from portbench import work

_BYTES = {"float32": 4, "bfloat16": 2}


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    m, B = r.model, r.traffic["sequences"]
    bound = took = 0.0
    for k in r.trace.kernels:
        if "rmsnorm" not in k.name:
            continue
        if k.graph:
            step = r.step_at(k.start)
            rows = step["bucket"] * B if step else None
        else:
            s = r.prefill_at(k.start)
            rows = B * s.req.length if s else None
        if rows is None:
            continue
        flops, nbytes = work.rmsnorm_work(rows, m["d_model"], _BYTES[m["dtype"]],
                                          _BYTES[m["param_dtype"]])
        bound += work.roofline_seconds(flops, nbytes, r.peaks)
        took += k.end - k.start
    return 100.0 * bound / took if took else None
