"""The readers of the program's spans (``key_ms``, ``step_wait_ms``,
``host_gap_ms``, ``queue_wait_p95_ms``) on synthetic span records, as
``test_portbench_window`` reads synthetic rings; none reads anything
without spans; a tiny window on the CPU with the program's spans on gives
each a number; and ``spanreport``'s idle labels and span means on a
synthetic trace."""
import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import harness, trace

PKG = Path(__file__).resolve().parents[1]
READERS = ("key_ms", "step_wait_ms", "host_gap_ms", "queue_wait_p95_ms")


def reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name, PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _readings(spans, t_open=10.0, t_close=20.0):
    win = harness.Window(t_open, t_close, [], [], (0, 0), attempted=0, failed=0, errors=[])
    r = harness.Readings(None, {}, {"sequences": 1}, win, None, None)
    r.spans = spans
    return r


def _span(name, t0, t1, thread="sched", **args):
    return {"id": 0, "parent": None, "name": name, "thread": thread, "t0": t0, "t1": t1,
            "args": args}


def _synthetic():
    """Steps of 40 ms on the scheduler thread, and one of 10 ms on another;
    of the scheduler's five, the first ends before the window opens and the
    last after it closes, the middle three start 50 ms apart. Each has a 30
    ms wait and a 1 ms replay key; each request is submitted 2 ms (rid 4:
    12 ms) before the step that serves it starts."""
    out = []
    starts = [9.91, 10.0, 10.05, 10.10, 19.98]
    for i, t0 in enumerate(starts):
        rids = [2 * i + 1, 2 * i + 2]
        for rid in rids:
            lead = 0.012 if rid == 4 else 0.002
            out.append(_span("submit.key", t0 - lead, t0 - lead + 0.0005, thread="client",
                             rid=rid))
        out.append(_span("step", t0, t0 + 0.04, class_id=0, step=i + 1, rids=rids))
        out.append(_span("replay.key", t0 + 0.001, t0 + 0.002, leaves=480))
        out.append(_span("step.wait", t0 + 0.005, t0 + 0.035))
    out.append(_span("step", 10.0, 10.01, thread="other", rids=[]))
    return out


def test_span_readers_on_synthetic_spans():
    r = _readings(_synthetic())
    # steps ending in [10, 20): the 2nd, 3rd and 4th on "sched", one on "other"
    keyed = 4 * 0.001 + 6 * 0.0005     # the replay and submit keys that end inside
    assert reader("key_ms")(r) == pytest.approx(1e3 * keyed / 4)
    assert reader("step_wait_ms")(r) == pytest.approx(30.0)
    assert reader("host_gap_ms")(r) == pytest.approx(10.0)     # 50 ms apart, 40 ms long
    # requests of the steps that began in the window: rids 3-8; rid 4 waited 12 ms
    assert reader("queue_wait_p95_ms")(r) == pytest.approx(12.0)
    r = _readings([s for s in _synthetic() if s["args"].get("rid") != 4])
    assert reader("queue_wait_p95_ms")(r) == pytest.approx(2.0)


def test_span_readers_read_nothing_without_spans():
    from repro_torch.core import spans

    spans.disable()
    for name in READERS:
        assert reader(name)(_readings(None)) is None, name
        assert reader(name)(_readings([])) is None, name
        # spans of another kind only
        assert reader(name)(_readings([_span("prefill", 10.1, 10.2)])) is None, name


def _tiny_cell():
    cell = harness.load_cell("glm4-gen")
    model = dict(cell.config["model"], num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, dtype="float32")
    cell.config = dict(cell.config, model=model)
    cell.traffic = dict(cell.traffic, sequences=2, prompt_len=[8, 16], output_tokens=12,
                        max_len=32, check_sequences=3)
    return cell


def test_a_window_with_the_programs_spans_gives_every_reader_a_number():
    from repro_torch.core import spans

    seed = 2**31 + 99
    system = harness.System(_tiny_cell(), seed, torch.device("cpu"))
    try:
        system.warm()
        spans.enable()
        win = harness.drive(system, seed, 1.5)
        r = harness.Readings(system.cell, system.cell.model, system.traffic, win, None, None)
        values = {name: reader(name)(r) for name in READERS}
        names = {s["name"] for s in spans.snapshot()}
    finally:
        spans.disable()
        system.close()
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert {"submit.key", "sched.pick", "step", "step.wait", "step.settle", "step.callbacks",
            "prefill", "prefill.caches"} <= names
    assert all(reader(name)(r) is None for name in READERS)     # spans off: nothing to read


def test_idle_gaps_take_the_innermost_span_open_at_their_start():
    report = harness.load_file(PKG / "spanreport.py")
    # the card is busy at [0, 10), [30, 50) and [200, 300) ms of a 350-ms trace
    tr = trace.Trace(0.0, 0.35, [trace.Kernel("k", lo, hi, False)
                                 for lo, hi in ((0.0, 0.01), (0.03, 0.05), (0.2, 0.3))])
    recs = [dict(_span("step", 0.0, 0.1), id=1),
            dict(_span("step.wait", 0.02, 0.08), id=2, parent=1),
            dict(_span("python.gc", 0.085, 0.095, thread="client", generation=2,
                       collected=0), id=3),
            dict(_span("prefill", 0.1, 0.2, thread="prefiller"), id=4)]
    out = report.idle_report(tr, recs, "sched", "prefiller")
    # each gap: its label, ms, ms under a collection, the oldest generation swept
    assert [[a, pytest.approx(b), pytest.approx(c), d] for a, b, c, d in out["idle_spans"]] == [
        ["step.wait", 150.0, 10.0, 2], ["none", 50.0, 0.0, None], ["step", 20.0, 0.0, None]]
    # the scheduler's spans come first (the collection on a client falls
    # under its step), then the prefill thread's
    assert out["idle_by_span"] == {"prefill": pytest.approx(0.1), "none": pytest.approx(0.05),
                                   "step.wait": pytest.approx(0.04),
                                   "step": pytest.approx(0.03)}
    assert out["gc_idle_s"] == pytest.approx(0.01) and out["idle_s"] == pytest.approx(0.22)
    assert out["idle_in_a_span_pct"] == pytest.approx(100 * 0.17 / 0.22)
    means = report.span_ms(recs, lambda t: t < 0.15)
    assert set(means) == {"step", "step.wait", "python.gc.2"}
    assert means["step"] == {"n": 1, "mean": pytest.approx(100.0), "max": pytest.approx(100.0),
                             "self": pytest.approx(40.0)}
