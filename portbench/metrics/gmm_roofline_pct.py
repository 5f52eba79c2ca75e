"""Grouped matmul's share of its roofline (kernels layer) in the traced
prefills: the least time the card could take for the experts' routed work
over the device time of the prefills' grouped-matmul launches.

The work is the rows the program routed: its ``prefill.moe`` span gives,
for each MoE layer of a prefill, the (token, choice) rows sent to the
experts the layer holds. A layer is three launches in order (up and gate,
d -> f; down, f -> d), each reading the held experts' weights and its
routed rows once and writing its output rows once, in bfloat16
(:func:`launch_work`): rows the program computes beyond the routed ones
count as no work. A prefill's launches in the trace are matched to its
layers in order; one the trace cuts at its start keeps its last launches,
one cut at its end its first.
"""
from portbench import program_spans as P
from portbench import work

NAMES = ("gmm_sm90_kernel", "gmm_bf16_kernel", "gmm_f32_kernel")


def launch_work(rows: int, groups: int, d_in: int, d_out: int,
                elem_bytes: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one grouped product of ``rows`` rows over ``groups``
    experts' (d_in, d_out) weights: x read, weights read, y written once."""
    return (2.0 * rows * d_in * d_out,
            float(elem_bytes * (rows * d_in + groups * d_in * d_out + rows * d_out)))


def launch_seconds(routed: int, product: int, m: dict, peaks: dict) -> float:
    """The least time for product ``product`` (0 up, 1 gate, 2 down) of an
    MoE layer over ``routed`` rows."""
    d, f = m["d_model"], m["moe_d_ff"]
    held = m.get("experts_held") or m["num_experts"]
    d_in, d_out = (f, d) if product == 2 else (d, f)
    return work.roofline_seconds(*launch_work(routed, held, d_in, d_out), peaks)


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    recs = P.records(r)
    if recs is None:
        return None
    tr = r.trace
    bound = took = 0.0
    for s in recs:
        if s["name"] != "prefill.moe":
            continue
        served = r.prefill_at(s["t0"])
        if served is None:
            continue
        t0, t1 = served.t_prefill, served.times[0]
        launches = sorted((k for k in tr.kernels if not k.graph and t0 <= k.start <= t1
                           and any(n in k.name for n in NAMES)), key=lambda k: k.start)
        routed = s["args"]["routed"]
        total = 3 * len(routed)
        cut_start, cut_end = t0 < tr.t_start, t1 > tr.t_stop
        if not launches or len(launches) > total or (cut_start and cut_end):
            continue
        first = total - len(launches) if cut_start else 0
        for j, k in enumerate(launches, first):
            bound += launch_seconds(routed[j // 3], j % 3, r.model, r.peaks)
            took += k.end - k.start
    return 100.0 * bound / took if took else None
