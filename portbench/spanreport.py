"""Where a cell's host and device time go, by the program's own spans.

    python3 portbench/spanreport.py --workload glm4-gen --seed 7 --seconds 50

Runs one cell as ``run.py --trace 1`` does (the same set-up, window and
device trace of its last seconds), with the program's spans recorded
(``repro_torch.core.spans``) from before the system is built to the
window's close; it checks no tokens against the reference. It prints one
JSON line:

* ``metrics``: the cell's per-layer metrics, read from these spans over the
  whole window (``run.py --trace 1`` reads the spans of its traced
  seconds), and ``tok_s`` / ``tpot_p95_ms`` of this traced run;
* ``span_ms``: for each span name (a collection's with its generation,
  ``python.gc.2``), over the spans that ended in the window, the count, the
  mean, the longest and the mean self time (less the time its child spans
  cover), in ms; ``span_ms_traced`` the same over the traced seconds, where
  the profiler's own cost shows, and ``span_ms_setup`` over the set-up
  (the tuner's refits and the captures they cause);
* ``idle_spans``: the ten longest device-idle gaps of the trace, each
  labelled with the innermost span open at its start on the scheduler's
  thread, else on the prefill thread, else ``python.gc`` on any thread,
  else ``none``, with its ms, the ms a collection on any thread overlapped
  and the oldest generation such a collection swept; ``idle_by_span``: the trace's idle seconds under each such
  label, and ``gc_idle_s``: those a collection on any thread overlapped;
* ``checks``: the share of the window the scheduler thread spends inside
  ``sched.*``, ``step*`` and ``python.gc`` spans; the share of the trace's
  idle seconds inside a span on some thread; and how far each
  ``record_function`` range the profiler saw starts from its span's
  ``t0``, mapped through the trace's clock marker (the profiler records
  the ranges of the thread that started it, the main thread).
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)
sys.path.insert(1, str(REPO / "src"))

import torch  # noqa: E402

from portbench import harness, trace  # noqa: E402

RUN = harness.load_file(harness.PKG / "run.py")
#: Span records kept: a 50-s window of either cell holds under a tenth.
CAPACITY = 1 << 18


class KeepingTracer(trace.Tracer):
    """A :class:`trace.Tracer` that also keeps the Chrome trace's events."""

    def read(self) -> trace.Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return trace.parse(self.events, self._mark, self.t_start, self.t_stop)


def span_ms(recs: list, inside) -> dict:
    """Count, mean, longest and mean self ms of each span label (:func:`_label`)
    ending ``inside``."""
    children: dict[int, list] = {}
    for s in recs:
        if s["parent"] is not None:
            children.setdefault(s["parent"], []).append(s)
    out: dict[str, list] = {}
    for s in recs:
        if not inside(s["t1"]):
            continue
        kids = _union([(c["t0"], c["t1"]) for c in children.get(s["id"], ())],
                      s["t0"], s["t1"])
        took = s["t1"] - s["t0"]
        row = out.setdefault(_label(s), [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += took
        row[2] = max(row[2], took)
        row[3] += took - sum(hi - lo for lo, hi in kids)
    return {k: {"n": n, "mean": 1e3 * t / n, "max": 1e3 * longest, "self": 1e3 * st / n}
            for k, (n, t, longest, st) in sorted(out.items())}


def _union(intervals, lo: float, hi: float) -> list:
    """The union of ``intervals`` clipped to [lo, hi]."""
    merged: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(a: list, b: list) -> float:
    """Seconds two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _label(s: dict) -> str:
    """A span's name; a collection's with its generation (``python.gc.2``)."""
    return f"python.gc.{s['args']['generation']}" if s["name"] == "python.gc" else s["name"]


def _innermost(lane: list) -> list:
    """(start, end, label) segments of the innermost open span over one
    thread's spans, which nest: a sweep with a stack."""
    segs, stack, t = [], [], None
    for s in sorted(lane, key=lambda s: (s["t0"], -s["t1"])):
        while stack and stack[-1]["t1"] <= s["t0"]:
            top = stack.pop()
            if top["t1"] > t:
                segs.append((t, top["t1"], _label(top)))
                t = top["t1"]
        if stack and s["t0"] > t:
            segs.append((t, s["t0"], _label(stack[-1])))
        t = s["t0"]
        stack.append(s)
    while stack:
        top = stack.pop()
        if top["t1"] > t:
            segs.append((t, top["t1"], _label(top)))
            t = top["t1"]
    return segs


class Labeller:
    """The innermost span open at an instant, by the precedence above."""

    def __init__(self, recs: list, sched: str, prefill: str | None):
        self.lanes = []
        for pick in (lambda s: s["thread"] == sched,
                     lambda s: s["thread"] == prefill,
                     lambda s: s["name"] == "python.gc"):
            segs = _innermost([s for s in recs if pick(s)])
            self.lanes.append((segs, [g[0] for g in segs]))
        self.edges = sorted({t for segs, _ in self.lanes for g in segs for t in g[:2]})

    def at(self, t: float) -> str:
        for segs, starts in self.lanes:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < segs[i][1]:
                return segs[i][2]
        return "none"

    def seconds_by_label(self, lo: float, hi: float, into: dict) -> None:
        """Add (lo, hi)'s seconds under each label to ``into``."""
        cuts = [lo] + self.edges[bisect.bisect_right(self.edges, lo):
                                 bisect.bisect_left(self.edges, hi)] + [hi]
        for a, b in zip(cuts, cuts[1:]):
            name = self.at((a + b) / 2)
            into[name] = into.get(name, 0.0) + (b - a)


def idle_report(tr: trace.Trace, recs: list, sched: str, prefill: str | None) -> dict:
    recs = [s for s in recs if s["t1"] > tr.t_start and s["t0"] < tr.t_stop]
    lab = Labeller(recs, sched, prefill)
    gaps = tr.idle_gaps()
    by: dict[str, float] = {}
    for lo, hi in gaps:
        lab.seconds_by_label(lo, hi, by)
    gc = _union([(s["t0"], s["t1"]) for s in recs if s["name"] == "python.gc"],
                tr.t_start, tr.t_stop)
    named = _union([(s["t0"], s["t1"]) for s in recs], tr.t_start, tr.t_stop)
    idle = sum(hi - lo for lo, hi in gaps)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    collections = [s for s in recs if s["name"] == "python.gc"]

    def oldest(lo: float, hi: float) -> int | None:
        """The oldest generation a collection overlapping (lo, hi) swept."""
        return max((s["args"]["generation"] for s in collections
                    if s["t0"] < hi and s["t1"] > lo), default=None)

    return {"idle_spans": [[lab.at(lo), 1e3 * (hi - lo), 1e3 * _overlap([(lo, hi)], gc),
                            oldest(lo, hi)] for lo, hi in longest],
            "idle_by_span": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "gc_idle_s": _overlap(gaps, gc), "idle_s": idle,
            "idle_in_a_span_pct": 100.0 * _overlap(gaps, named) / idle if idle else None}


def marker_check(events: list, mark: float, recs: list) -> dict:
    """How far each span's ``record_function`` range starts from its ``t0``."""
    ts_mark = next(e["ts"] for e in events if e.get("name") == trace.MARKER and "dur" in e)
    by_name: dict[str, list] = {}
    for s in recs:
        by_name.setdefault(s["name"], []).append(s["t0"])
    for starts in by_name.values():
        starts.sort()
    off = []
    for e in events:
        starts = by_name.get(e.get("name"))
        if starts is None or e.get("cat") != "user_annotation" or "dur" not in e:
            continue
        t = mark + (e["ts"] - ts_mark) / 1e6
        i = bisect.bisect_left(starts, t)
        off.append((min(abs(starts[j] - t) for j in (i - 1, i) if 0 <= j < len(starts)),
                    e["name"], e.get("tid")))
    far = sorted((o for o in off if o[0] > 2e-4), reverse=True)
    return {"ranges": len(off), "within_0.2ms": len(off) - len(far),
            "max_ms": 1e3 * max(o[0] for o in off) if off else None,
            "outside": [[1e3 * o, name, tid] for o, name, tid in far[:5]]}


def traced(cell: harness.Cell, seed: int, seconds: float, device: torch.device) -> dict:
    from repro_torch.core import spans

    tracer = KeepingTracer(cell.traffic["trace_seconds"])
    spans.enable(CAPACITY)
    try:
        system = harness.System(cell, seed, device)
        system.warm()
        win = harness.drive(system, seed, seconds, tracer)
        recs = spans.snapshot()
    finally:
        spans.disable()
    tr = tracer.read()
    r = harness.Readings(cell, cell.model, cell.traffic, win, tr, harness.peaks(device))
    r.spans = recs
    metrics = {m["name"]: RUN.load_reader(m["name"])(r) for m in cell.metrics("per_layer")}
    metrics.update({k: v for k, v in RUN.end_to_end(r, 0.0).items() if k != "setup_s"})
    sched = f"{system.server.name}-dispatch"
    prefills = [s["thread"] for s in recs if s["name"] == "prefill" and win.inside(s["t1"])]
    prefill = max(set(prefills), key=prefills.count) if prefills else None
    mine = [s for s in recs if s["thread"] == sched and (
        s["name"].startswith(("sched.", "step")) or s["name"] == "python.gc")]
    covered = sum(hi - lo for lo, hi in _union([(s["t0"], s["t1"]) for s in mine],
                                               win.t_open, win.t_close))
    system.close()
    return {"metrics": metrics, "span_ms": span_ms(recs, win.inside),
            "span_ms_traced": span_ms(recs, lambda t: tr.t_start <= t < tr.t_stop),
            "span_ms_setup": span_ms(recs, lambda t: t < win.t_open),
            **idle_report(tr, recs, sched, prefill),
            "checks": {"sched_covered_pct": 100.0 * covered / win.seconds,
                       "marker": marker_check(tracer.events, tracer._mark, recs)},
            "trace_s": tr.window_s, "busy_s": tr.busy_s(), "steps": sum(
                1 for s in recs if s["name"] == "step" and win.inside(s["t1"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spanreport: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda:0")
    out = traced(cell, args.seed, args.seconds, device)
    out.update(workload=args.workload, seed=args.seed,
               card=torch.cuda.get_device_name(device), power_limit=RUN.power_limit())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
