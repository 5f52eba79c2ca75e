"""The port's continuous (iteration-level) server against the JAX server.

The same numpy-seeded regions (the reference's ``_region`` / ``_bufs`` of
``tests/test_serving.py``: a 2-wave x 2-column grid of ``tanh(x @ w) * 0.5 +
x`` tasks over a shared ``w``) go through ``repro.serving.RegionServer`` and
``repro_torch.serving.RegionServer`` on the same schedule (``autostart=False``,
submit, then ``start()``). Outputs must agree at f32 2e-5; the trace records
must be equal field by field (step, class, occupancy, bucket, joins, leaves,
sheds, coalesced, padded, tiers; not the clocks); pool hits and misses must be
equal. Each case of ``TestContinuous`` is ported, a bucket-tuner refit is
held to ``fit_boundaries`` of the same observations, and the trace ring and
per-tier latency of ``serving/metrics.py`` are held to the reference's on the
same events.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import TDG as JTDG  # noqa: E402
from repro.core import ReplayExecutor as JReplay  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.serving import RegionServer as JServer  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro_torch.core import TDG as TTDG  # noqa: E402
from repro_torch.core import ReplayExecutor as TReplay  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.serving import RegionServer as TServer  # noqa: E402
from repro_torch.serving import metrics as tmetrics  # noqa: E402
from repro_torch.serving.demo import demo_mix, demo_region  # noqa: E402

TOL = 2e-5
TRACE_FIELDS = ("step", "class_id", "occupancy", "bucket", "joins", "leaves", "sheds",
                "coalesced", "padded", "tiers")


def _jbody(x, w):
    return jnp.tanh(x @ w) * 0.5 + x


def _tbody(x, w):
    return torch.tanh(x @ w) * 0.5 + x


J = types.SimpleNamespace(TDG=JTDG, Server=JServer, Replay=JReplay, body=_jbody,
                          arr=lambda a: jnp.asarray(a, jnp.float32), np=np.asarray)
T = types.SimpleNamespace(TDG=TTDG, Server=TServer, Replay=TReplay, body=_tbody,
                          arr=lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                          np=lambda t: t.numpy())


def _region(P, i, waves=2, width=2):
    tdg = P.TDG(f"srv[{i}]")
    for wv in range(waves):
        for s in range(width):
            tdg.add_task(P.body, ins=[f"x{s}", "w"], outs=[f"x{s}"], name=f"t{wv}.{s}")
    return tdg


def _bufs(P, seed, w, dim=6, width=2):
    rng = np.random.default_rng(seed)
    return {**{f"x{s}": P.arr(rng.standard_normal((dim, dim))) for s in range(width)},
            "w": w}


def _w(P, seed):
    return P.arr(np.random.default_rng(seed).standard_normal((6, 6)))


def _chain(P, tdg, start, steps):
    """Serial oracle: replay ``steps`` times, outputs carried into inputs."""
    ex = P.Replay(tdg)
    bufs, out = dict(start), {}
    for _ in range(steps):
        out = ex.run(dict(bufs))
        bufs.update({k: v for k, v in out.items() if k in bufs})
    return out


def _trace(server):
    return [{k: r[k] for k in TRACE_FIELDS} for r in server.metrics.trace.snapshot()]


def _counts(server):
    pool = server.pool.stats()
    return {"trace": _trace(server), "pool": (pool["hits"], pool["misses"], pool["hot"]),
            "metrics": {k: v for k, v in server.metrics.snapshot().items()
                        if k in ("admitted", "completed", "failed", "batches", "joins",
                                 "leaves", "coalesced_requests", "pad_lanes", "shed",
                                 "deadline_sheds", "rate_limited", "batch_fallbacks")}}


def _assert_outputs(jouts, touts):
    assert len(jouts) == len(touts)
    for jo, to in zip(jouts, touts):
        assert set(jo) == set(to)
        for k in jo:
            np.testing.assert_allclose(T.np(to[k]), J.np(jo[k]), rtol=TOL, atol=TOL)


def _both(run):
    """Run ``run(P)`` for both packages; outputs and counts must agree."""
    (jouts, jserver), (touts, tserver) = run(J), run(T)
    _assert_outputs(jouts, touts)
    assert _counts(tserver) == _counts(jserver)
    return jserver, tserver, touts


def test_stream_parity_vs_replay_chain():
    def run(P):
        w = _w(P, 7)
        server = P.Server(max_batch=4, continuous=True, autostart=False)
        tenants = []
        for i in range(3):
            tdg = _region(P, i)
            server.register_tenant(f"t{i}", tdg)
            tenants.append((tdg, _bufs(P, 200 + i, w)))
        futs = [server.submit_stream(f"t{i}", b, steps=5) for i, (_, b) in enumerate(tenants)]
        server.start()
        outs = [f.result(120) for f in futs]
        server.close()
        run.tenants = tenants
        return outs, server

    _, tserver, touts = _both(run)
    for (tdg, b), out in zip(run.tenants, touts):      # the port against its own oracle
        want = _chain(T, tdg, b, 5)
        for k in want:
            np.testing.assert_allclose(out[k].numpy(), want[k].numpy(), rtol=TOL, atol=TOL)
    assert [r["occupancy"] for r in _trace(tserver)] == [3] * 5


def test_join_leave_mid_stream_no_retrace():
    def run(P):
        w = _w(P, 8)
        server = P.Server(max_batch=4, continuous=True, autostart=False)
        plans = [4, 4, 2, 2]
        futs = []
        for i, steps in enumerate(plans):
            server.register_tenant(f"t{i}", _region(P, i))
            futs.append(server.submit_stream(f"t{i}", _bufs(P, 210 + i, w), steps=steps))
        server.start()
        outs = [f.result(120) for f in futs]
        server.close()
        return outs, server

    _, tserver, _ = _both(run)
    trace = _trace(tserver)
    assert [r["occupancy"] for r in trace] == [4, 4, 2, 2]
    assert trace[1]["leaves"] == 2 and trace[3]["leaves"] == 2
    m = tserver.metrics.snapshot()
    assert m["joins"] == 4 and m["leaves"] == 4 and m["batches"] == 4
    pool = tserver.pool.stats()
    assert (pool["misses"], pool["hits"]) == (1, 3)
    assert pool["hot"] == [{"kind": "batched", "hits": 3}]


def test_mid_stream_join_and_early_leave_parity():
    def run(P):
        w = P.arr(np.eye(6))
        server = P.Server(max_batch=2, continuous=True, autostart=False)
        server.register_tenant("a", _region(P, "a"))
        server.register_tenant("b", _region(P, "b"))
        fa = server.submit_stream("a", _bufs(P, 220, w), steps=3)
        fb = server.submit("b", _bufs(P, 221, w))
        server.start()
        outs = [fa.result(120), fb.result(120)]
        server.close()
        return outs, server

    _, tserver, _ = _both(run)
    trace = _trace(tserver)
    assert [r["occupancy"] for r in trace] == [2, 1, 1]
    assert trace[0]["joins"] == 2 and trace[0]["leaves"] == 1


def test_deterministic_step_boundary_admission():
    def run(P):
        w = P.arr(np.eye(6))
        server = P.Server(max_batch=2, continuous=True, autostart=False)
        for i in range(8):
            server.register_tenant(f"t{i}", _region(P, i), tier=i % 2)
        futs = [server.submit(f"t{i % 8}", _bufs(P, 230 + i, w)) for i in range(24)]
        server.start()
        outs = [f.result(120) for f in futs]
        server.close()
        return outs, server

    _, tserver, _ = _both(run)
    tiers = [r["tiers"] for r in _trace(tserver)]
    assert len(tiers) == 12 and tiers[0] == {"0": 1, "1": 1}
    assert tiers[-3:] == [{"0": 2}] * 3          # tier 1 drains first


def test_submit_stream_requires_continuous():
    for P in (J, T):
        with P.Server(continuous=False) as server:
            server.register_tenant("a", _region(P, 0))
            with pytest.raises(RuntimeError, match="continuous"):
                server.submit_stream("a", _bufs(P, 0, _w(P, 0)), steps=2)
        with P.Server(continuous=True) as server:
            server.register_tenant("a", _region(P, 0))
            with pytest.raises(ValueError, match="steps"):
                server.submit_stream("a", _bufs(P, 0, _w(P, 0)), steps=0)


def test_continuous_stats_flag_and_trace_dump(tmp_path):
    docs = {}
    for P, name in ((J, "jax"), (T, "torch")):
        with P.Server(continuous=True) as server:
            server.register_tenant("a", _region(P, 0))
            out = server.serve("a", _bufs(P, 240, _w(P, 240)))
            assert server.stats()["continuous"] is True
            docs[name] = (server.dump_trace(str(tmp_path / f"{name}.json")), out)
    (jdoc, jout), (tdoc, tout) = docs["jax"], docs["torch"]
    _assert_outputs([jout], [tout])
    assert tdoc["schema"] == jdoc["schema"] and tdoc["summary"] == jdoc["summary"]
    assert [{k: r[k] for k in TRACE_FIELDS} for r in tdoc["records"]] == \
        [{k: r[k] for k in TRACE_FIELDS} for r in jdoc["records"]]
    assert json.loads((tmp_path / "torch.json").read_text())["summary"]["steps"] == 1


def test_scheduler_spans_join_the_trace_ring(tmp_path):
    """With spans on, every step on the scheduler thread yields ``sched.pick``,
    ``step``, ``step.wait`` and ``step.settle`` in that order; each ``step``
    joins its ring record by (class_id, step) and lasts its ``wall_ms``; the
    dump carries both, each checked against its schema."""
    from repro_torch.core import spans

    spans.enable()
    try:
        w = _w(T, 9)
        server = T.Server(max_batch=4, continuous=True, autostart=False)
        futs = []
        for i, steps in enumerate([3, 3, 2]):
            server.register_tenant(f"t{i}", _region(T, i))
            futs.append(server.submit_stream(f"t{i}", _bufs(T, 250 + i, w), steps=steps))
        server.start()
        for f in futs:
            f.result(120)
        server.close()
        doc = server.dump_trace(str(tmp_path / "trace.json"))
    finally:
        spans.disable()
    ring = {(r["class_id"], r["step"]): r for r in doc["records"]}
    sched = [s for s in doc["spans"] if s["thread"] == server._thread.name]
    steps = [s for s in sched if s["name"] == "step"]
    assert len(steps) == len(ring) == 3
    for st in steps:
        rec = ring[(st["args"]["class_id"], st["args"]["step"])]
        assert abs((st["t1"] - st["t0"]) * 1e3 - rec["wall_ms"]) < 0.1
        assert st["args"]["occupancy"] == rec["occupancy"]
        assert st["args"]["bucket"] == rec["bucket"]
        pick = max((s for s in sched if s["name"] == "sched.pick" and s["t1"] <= st["t0"]
                    and s["args"].get("class_id") == rec["class_id"]), key=lambda s: s["t0"])
        wait = [s for s in sched if s["name"] == "step.wait" and s["parent"] == st["id"]]
        settle = min((s for s in sched if s["name"] == "step.settle" and s["t0"] >= st["t1"]),
                     key=lambda s: s["t0"])
        assert len(wait) == 1
        assert pick["t1"] <= st["t0"] <= wait[0]["t0"] <= wait[0]["t1"] <= st["t1"] \
            <= settle["t0"]
    on_disk = json.loads((tmp_path / "trace.json").read_text())
    assert on_disk["span_schema"] == sorted(spans.SPAN_SCHEMA)
    spans.validate_spans(on_disk["spans"])
    tmetrics.validate_trace(on_disk["records"])
    assert server.stats()["graphs"]["evictions"] == 0


def test_continuous_is_the_default_and_env_selects(monkeypatch):
    for P in (J, T):
        monkeypatch.delenv("REPRO_CONTINUOUS", raising=False)
        assert P.Server(autostart=False).continuous is True
        monkeypatch.setenv("REPRO_CONTINUOUS", "0")
        assert P.Server(autostart=False).continuous is False
        assert P.Server(autostart=False, continuous=True).continuous is True


def test_signature_drift_migrates_to_a_new_class():
    """A member whose outputs change its buffer signature leaves its class
    and joins the one that matches; the batch it left keeps stepping."""
    def run(P):
        grow = (lambda x: jnp.concatenate([x, x], 0)) if P is J else \
            (lambda x: torch.cat([x, x], 0))
        server = P.Server(max_batch=2, continuous=True, autostart=False)
        futs = []
        for i in range(2):
            tdg = P.TDG(f"g[{i}]")
            tdg.add_task(grow, ins=["x"], outs=["x"])
            server.register_tenant(f"g{i}", tdg)
            x = P.arr(np.random.default_rng(250 + i).standard_normal((2, 3)))
            futs.append(server.submit_stream(f"g{i}", {"x": x}, steps=3))
        server.start()
        outs = [f.result(120) for f in futs]
        server.close()
        return outs, server

    _, tserver, touts = _both(run)
    assert [tuple(o["x"].shape) for o in touts] == [(16, 3), (16, 3)]
    assert [(r["class_id"], r["occupancy"], r["leaves"]) for r in _trace(tserver)] == \
        [(0, 2, 2), (1, 2, 2), (2, 2, 2)]


@pytest.mark.parametrize("adaptive", ["1", "0"])
def test_bucket_refit_matches_fit_boundaries(monkeypatch, adaptive):
    """Adaptive buckets (``REPRO_ADAPTIVE``; the port's name is
    ``REPRO_TORCH_ADAPTIVE``): on, a window-3 tuner refits the ladder from
    occupancy-3 steps to ``fit_boundaries`` of the observed histogram and
    invalidates the pool's batched entry; off, the pow-2 ladder stays. The
    port's refits, pads and invalidations match the JAX server's."""
    monkeypatch.setenv("REPRO_ADAPTIVE", adaptive)
    monkeypatch.setenv("REPRO_TORCH_ADAPTIVE", adaptive)

    def run(P, cm):
        server = P.Server(max_batch=8, continuous=True, autostart=False)
        assert server.adaptive is (adaptive == "1")
        server.buckets = cm.BucketTuner(server.max_batch, window=3)
        w = _w(P, 9)
        futs = []
        for i in range(3):
            server.register_tenant(f"t{i}", _region(P, i))
            futs.append(server.submit_stream(f"t{i}", _bufs(P, 260 + i, w), steps=5))
        server.start()
        outs = [f.result(120) for f in futs]
        server.close()
        return outs, server

    jouts, jserver = run(J, jcm)
    touts, tserver = run(T, tcm)
    _assert_outputs(jouts, touts)
    assert _counts(tserver) == _counts(jserver)
    tb, jb = tserver.stats()["buckets"], jserver.stats()["buckets"]
    assert tb == jb
    trace = _trace(tserver)
    m, pool = tserver.metrics.snapshot(), tserver.pool.stats()
    if adaptive == "1":
        assert tb["retunes"] == 1 and tb["boundaries"] == tcm.fit_boundaries({3: 3}, 8) == [3]
        assert [(r["bucket"], r["padded"]) for r in trace] == [(4, 1)] * 2 + [(3, 0)] * 3
        assert m["bucket_retunes"] == 1 and m["pad_lanes"] == 2 and pool["invalidations"] == 1
    else:
        assert tb["retunes"] == 0 and tb["boundaries"] == tcm.pow2_boundaries(8)
        assert [(r["bucket"], r["padded"]) for r in trace] == [(4, 1)] * 5
        assert m["bucket_retunes"] == 0 and m["pad_lanes"] == 5 and pool["invalidations"] == 0


def test_demo_region_matches_reference_demo():
    from repro.serving.demo import demo_region as jdemo_region
    jt, tt = jdemo_region("d", waves=3, width=2), demo_region("d", waves=3, width=2)
    assert [(t.ins, t.outs, t.name) for t in tt.tasks] == \
        [(t.ins, t.outs, t.name) for t in jt.tasks]
    rng = np.random.default_rng(3)
    x, w = rng.standard_normal((5, 5)), rng.standard_normal((5, 5))
    np.testing.assert_allclose(demo_mix(T.arr(x), T.arr(w)).numpy(),
                               np.asarray(_jbody(J.arr(x), J.arr(w))), rtol=TOL, atol=TOL)


# ------------------------------------------------------- trace ring and tiers

def _events(m, trace_walls):
    """One fixed sequence of metric events (with the ring's clock pinned)."""
    m.on_admit(3)
    m.on_admit_many(4, 7)
    for tier, lat in ((0, 0.004), (1, 0.002), (0, 0.008), (2, 0.001), (1, 0.003)):
        m.on_done(lat, tier=tier)
    m.on_done(0.5, failed=True, tier=0)
    m.on_batch(3, coalesced=True)
    m.on_batch(2, coalesced=False)
    m.on_pad(1)
    m.on_pad(0)
    m.on_bucket_retune([3, 8])
    m.on_rate_limited(2)
    m.on_shed()
    m.on_deadline_shed(3)
    m.on_batch_fallback()
    for i, wall in enumerate(trace_walls):
        m.on_step({"step": i + 1, "class_id": i % 2, "t_ms": float(i), "occupancy": 2,
                   "bucket": 2, "joins": i % 3, "leaves": 1, "sheds": 0, "wall_ms": wall,
                   "coalesced": True, "padded": 0, "tiers": {"0": 1, "1": 1}})


def test_metrics_snapshot_and_per_tier_latency_match_reference():
    walls = [1.0] * 6 + [10.0, 1.0, 5.0, 2.0] * 2 + [1.0] * 6
    jm, tm = jmetrics.ServerMetrics(), tmetrics.ServerMetrics()
    _events(jm, walls)
    _events(tm, walls)
    js, ts = jm.snapshot(), tm.snapshot()
    assert set(ts) == set(js)
    assert ts == js
    assert ts["tiers"]["0"]["count"] == 2 and ts["tiers"]["1"]["p99_s"] == 0.003
    assert "0" in ts["tiers"] and ts["tiers"]["0"]["max_s"] == 0.008   # failed not in a tier
    assert ts["trace"]["stragglers"] >= 1 and ts["joins"] == sum(i % 3 for i in range(len(walls)))


@pytest.mark.parametrize("capacity", [4, 64])
def test_trace_ring_matches_reference(capacity, tmp_path):
    walls = [2.0] * 5 + [7.0, 2.0, 20.0, 2.0, 6.1, 1.0] + [3.0] * 4
    rings = []
    for mod in (jmetrics, tmetrics):
        ring = mod.ExecutionTraceRing(capacity=capacity)
        for i, wall in enumerate(walls):
            ring.record({"step": i + 1, "class_id": i % 2, "t_ms": float(i),
                         "occupancy": 1 + i % 3, "bucket": 1, "joins": 0, "leaves": 0,
                         "sheds": 0, "wall_ms": wall, "coalesced": False, "padded": 0,
                         "tiers": {"0": 1}})
        rings.append(ring)
    jring, tring = rings
    assert tring.snapshot() == jring.snapshot()
    assert tring.summary() == jring.summary()
    assert len(tring.snapshot()) == min(capacity, len(walls))
    jdoc = jring.dump(str(tmp_path / "j.json"), meta={"server": "s"})
    tdoc = tring.dump(str(tmp_path / "t.json"), meta={"server": "s"})
    assert tdoc == jdoc
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


@pytest.mark.parametrize("bad", [
    "not a dict", "missing", "extra", "bool step", "tiers", "float occupancy"])
def test_validate_trace_matches_reference(bad):
    good = {"step": 1, "class_id": 0, "t_ms": 0.5, "occupancy": 2, "bucket": 2, "joins": 1,
            "leaves": 0, "sheds": 0, "wall_ms": 1.0, "straggler": False, "coalesced": True,
            "padded": 0, "tiers": {"0": 2}}
    tmetrics.validate_trace([good])
    assert tmetrics.TRACE_SCHEMA == jmetrics.TRACE_SCHEMA
    rec = {"missing": {"step": 1}, "extra": {**good, "x": 1}, "bool step": {**good, "step": True},
           "tiers": {**good, "tiers": {0: 2}},
           "float occupancy": {**good, "occupancy": 2.0}}.get(bad, bad)
    errors = []
    for mod in (jmetrics, tmetrics):
        with pytest.raises(ValueError) as info:
            mod.validate_trace([good, rec])
        errors.append(str(info.value))
    assert errors[0] == errors[1] and errors[1].startswith("trace[1]")


def test_percentile_and_reservoir_match_reference():
    vals = [float(i) for i in range(1, 11)]
    for q in (0, 50, 99, 100):
        assert tmetrics.percentile(vals, q) == jmetrics.percentile(vals, q)
    assert tmetrics.percentile([], 50) == jmetrics.percentile([], 50) == 0.0
    jr, tr = jmetrics.LatencyReservoir(capacity=8), tmetrics.LatencyReservoir(capacity=8)
    for i in range(100):
        jr.record(float(i))
        tr.record(float(i))
    assert tr.summary() == jr.summary() and tr.summary()["max_s"] == 99.0
