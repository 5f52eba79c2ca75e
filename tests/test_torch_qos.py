"""The port's QoS admission against the JAX server's.

``repro_torch.serving.qos`` (token buckets, smooth weighted round robin,
the tier and rate env specs) and the server's admission control (rate
limits, the bounded queue with tier-aware eviction, deadlines,
``submit_many``) are driven with the same schedule through both packages'
``RegionServer``: outcomes (result or the same typed error), outputs (f32
2e-5), metrics and trace records must agree. Each case of
``tests/test_serving.py::TestQoS`` is ported.
"""
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import TDG as JTDG  # noqa: E402
from repro.serving import RegionServer as JServer  # noqa: E402
from repro.serving import qos as jqos  # noqa: E402
from repro.serving import server as jserver_mod  # noqa: E402
from repro_torch.core import TDG as TTDG  # noqa: E402
from repro_torch.serving import RegionServer as TServer  # noqa: E402
from repro_torch.serving import qos as tqos  # noqa: E402
from repro_torch.serving import server as tserver_mod  # noqa: E402

TOL = 2e-5
TRACE_FIELDS = ("step", "class_id", "occupancy", "bucket", "joins", "leaves", "sheds",
                "coalesced", "padded", "tiers")


def _jbody(x, w):
    return jnp.tanh(x @ w) * 0.5 + x


def _tbody(x, w):
    return torch.tanh(x @ w) * 0.5 + x


J = types.SimpleNamespace(TDG=JTDG, Server=JServer, mod=jserver_mod, body=_jbody,
                          arr=lambda a: jnp.asarray(a, jnp.float32), np=np.asarray)
T = types.SimpleNamespace(TDG=TTDG, Server=TServer, mod=tserver_mod, body=_tbody,
                          arr=lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                          np=lambda t: t.numpy())


def _region(P, i):
    tdg = P.TDG(f"srv[{i}]")
    for wv in range(2):
        for s in range(2):
            tdg.add_task(P.body, ins=[f"x{s}", "w"], outs=[f"x{s}"], name=f"t{wv}.{s}")
    return tdg


def _bufs(P, seed, w=None):
    rng = np.random.default_rng(seed)
    b = {f"x{s}": P.arr(rng.standard_normal((6, 6))) for s in range(2)}
    b["w"] = w if w is not None else P.arr(rng.standard_normal((6, 6)))
    return b


def _outcome(fut):
    """A future's result, or the name of the error it failed with."""
    try:
        return fut.result(120)
    except Exception as e:       # the typed error is the outcome
        return type(e).__name__


def _same(jres, tres, jserver, tserver):
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        if isinstance(j, str):
            assert t == j
        else:
            assert set(t) == set(j)
            for k in j:
                np.testing.assert_allclose(T.np(t[k]), J.np(j[k]), rtol=TOL, atol=TOL)
    keys = ("admitted", "completed", "failed", "shed", "deadline_sheds", "rate_limited",
            "batches", "joins", "leaves")
    jm, tm = jserver.metrics.snapshot(), tserver.metrics.snapshot()
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert [{k: r[k] for k in TRACE_FIELDS} for r in tserver.metrics.trace.snapshot()] == \
        [{k: r[k] for k in TRACE_FIELDS} for r in jserver.metrics.trace.snapshot()]


def _both(run):
    (jres, js), (tres, ts) = run(J), run(T)
    _same(jres, tres, js, ts)
    return tres, ts


def test_token_bucket_accounting_under_burst():
    for qos in (jqos, tqos):
        b = qos.TokenBucket(rate=2.0, burst=2.0, now=0.0)
        assert b.take(now=0.0) and b.take(now=0.0)      # burst drains
        assert not b.take(now=0.0)
        assert not b.take(now=0.4)                      # 0.8 tokens: < 1
        assert b.take(now=0.5)                          # refilled exactly 1
        assert not b.take(now=0.5)
        assert b.available(now=100.0) == pytest.approx(2.0)   # capped
        assert b.take(n=2, now=100.0)
        with pytest.raises(ValueError):
            qos.TokenBucket(rate=0.0)
    rng = np.random.default_rng(11)
    jb, tb = jqos.TokenBucket(3.0, now=0.0), tqos.TokenBucket(3.0, now=0.0)
    t = 0.0
    for dt, n in zip(rng.exponential(0.2, 200), rng.integers(1, 3, 200)):
        t += float(dt)
        assert tb.take(int(n), now=t) == jb.take(int(n), now=t)
        assert tb.available(now=t) == pytest.approx(jb.available(now=t))


def test_smooth_wrr_is_proportional_and_interleaved():
    for qos in (jqos, tqos):
        wrr = qos.SmoothWRR()
        assert [wrr.pick({1: 2, 0: 1}) for _ in range(6)] == [1, 0, 1, 1, 0, 1]
        assert qos.tier_weight(1) == 2 * qos.tier_weight(0)
        assert qos.SmoothWRR().pick({}) is None
    rng = np.random.default_rng(12)
    jw, tw = jqos.SmoothWRR(), tqos.SmoothWRR()
    for _ in range(300):     # candidates coming and going, tier weights 2**t
        cands = {int(k): tqos.tier_weight(int(k)) for k in rng.choice(5, rng.integers(1, 5),
                                                                     replace=False)}
        assert tw.pick(cands) == jw.pick(cands)
    assert [tqos.tier_weight(t) for t in (-1, 0, 3, 40)] == \
        [jqos.tier_weight(t) for t in (-1, 0, 3, 40)]


def test_rate_limited_is_typed_and_counted():
    def run(P):
        server = P.Server(continuous=True, autostart=False)
        server.register_tenant("a", _region(P, 0), rate=1.0)   # burst of 1
        fut = server.submit("a", _bufs(P, 0))
        with pytest.raises(P.mod.RateLimited, match="rate limit"):
            server.submit("a", _bufs(P, 1))
        server.start()
        res = [_outcome(fut)]
        server.close()
        return res, server

    _, server = _both(run)
    m = server.metrics.snapshot()
    assert m["rate_limited"] == 1 and m["completed"] == 1


def test_low_tier_shed_first_at_queue_bound():
    def run(P):
        w = P.arr(np.eye(6))
        server = P.Server(max_batch=8, continuous=True, autostart=False, queue_bound=4)
        server.register_tenant("low", _region(P, "lo"), tier=0)
        server.register_tenant("high", _region(P, "hi"), tier=1)
        low = [server.submit("low", _bufs(P, 300 + i, w)) for i in range(4)]
        high = server.submit("high", _bufs(P, 310, w))
        with pytest.raises(P.mod.QueueFull, match="tier-1"):
            low[-1].result(1)                   # the newest low waiter was shed
        with pytest.raises(P.mod.QueueFull):
            server.submit("low", _bufs(P, 311, w))
        server.start()
        res = [_outcome(f) for f in low + [high]]
        server.close()
        return res, server

    res, server = _both(run)
    assert res[3] == "QueueFull"
    m = server.metrics.snapshot()
    assert m["shed"] == 2 and m["completed"] == 4


def test_qos_env_defaults(monkeypatch):
    monkeypatch.setenv("REPRO_TENANT_TIER", "a=2,*=0")
    monkeypatch.setenv("REPRO_TENANT_RATE", "a=5,*=0")
    for P in (J, T):
        with P.Server(autostart=False) as server:
            ta = server.register_tenant("a", _region(P, 0))
            tb = server.register_tenant("b", _region(P, 1))
        assert ta.tier == 2 and ta.rate == 5.0 and ta.bucket is not None
        assert tb.tier == 0 and tb.rate == 0.0 and tb.bucket is None
    for raw in ("", "3", "a=1", "b=1,*=4", "a=x", "*=2.5", " a = 7 , b=1"):
        monkeypatch.setenv("REPRO_TENANT_TIER", raw)
        monkeypatch.setenv("REPRO_TENANT_RATE", raw)
        for name in ("a", "b"):
            assert tqos.tenant_tier_default(name) == jqos.tenant_tier_default(name)
            assert tqos.tenant_rate_default(name) == jqos.tenant_rate_default(name)


def test_typed_errors_cross_the_wire_by_name():
    """The port's typed errors carry the reference's names, which is what
    each package's cluster wire maps back to its own type."""
    from repro.serving import rpc
    from repro_torch.serving import rpc as trpc
    for name in ("QueueFull", "DeadlineExceeded", "RateLimited"):
        cls = getattr(tserver_mod, name)
        assert cls.__name__ == name and issubclass(cls, RuntimeError)
        assert rpc.wire_error_class(f"{cls.__name__}: x") is getattr(jserver_mod, name)
        assert trpc.wire_error_class(f"{cls.__name__}: x") is cls


def test_queue_bound_env_default(monkeypatch):
    for raw, want in (("", 0), ("7", 7), ("-3", 0)):
        monkeypatch.setenv("REPRO_QUEUE_BOUND", raw)
        assert tserver_mod.queue_bound_default() == jserver_mod.queue_bound_default() == want
        assert TServer(autostart=False).queue_bound == want


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "request-level"])
def test_deadline_passed_while_queued_is_shed(continuous):
    def run(P):
        w = P.arr(np.eye(6))
        server = P.Server(max_batch=4, continuous=continuous, autostart=False)
        for i in range(3):
            server.register_tenant(f"t{i}", _region(P, i))
        soon = time.monotonic() + 0.05
        futs = [server.submit("t0", _bufs(P, 320, w), deadline=soon),
                server.submit("t1", _bufs(P, 321, w)),
                server.submit("t2", _bufs(P, 322, w), deadline=time.monotonic() + 300)]
        time.sleep(0.1)                          # t0's deadline passes in the queue
        server.start()
        res = [_outcome(f) for f in futs]
        server.close()
        return res, server

    res, server = _both(run)
    assert res[0] == "DeadlineExceeded" and not isinstance(res[1], str)
    m = server.metrics.snapshot()
    assert m["deadline_sheds"] == 1 and m["failed"] == 1 and m["completed"] == 2


def test_submit_many_fails_entries_one_by_one():
    def run(P):
        w = P.arr(np.eye(6))
        server = P.Server(max_batch=8, continuous=True, autostart=False, queue_bound=3)
        server.register_tenant("a", _region(P, "a"))
        server.register_tenant("r", _region(P, "r"), rate=1.0)
        futs = server.submit_many([
            ("a", _bufs(P, 330, w)),
            ("nobody", _bufs(P, 331, w)),                       # unknown tenant
            ("a", {"w": w}),                                    # missing slots
            ("a", _bufs(P, 332, w), time.monotonic() - 1.0),    # deadline passed
            ("r", _bufs(P, 333, w)),
            ("r", _bufs(P, 334, w)),                            # rate limited
            ("a", _bufs(P, 335, w), None),
            ("a", _bufs(P, 336, w)),                            # over the bound
        ])
        server.start()
        res = [_outcome(f) for f in futs]
        server.close()
        return res, server

    res, server = _both(run)
    assert [r if isinstance(r, str) else "ok" for r in res] == [
        "ok", "KeyError", "KeyError", "DeadlineExceeded", "ok", "RateLimited", "ok",
        "QueueFull"]
    m = server.metrics.snapshot()
    assert (m["admitted"], m["rate_limited"], m["shed"], m["deadline_sheds"]) == (3, 1, 1, 1)


def test_tier_weighted_step_order_across_classes():
    """Two structure classes, one holding a tier-1 member: the class WRR
    gives it ~2x the steps while both are busy."""
    def run(P):
        w = P.arr(np.eye(6))
        server = P.Server(max_batch=1, continuous=True, autostart=False)
        server.register_tenant("hi", _region(P, "hi"), tier=1)
        other = P.TDG("other")
        other.add_task(P.body, ins=["x0", "w"], outs=["x0"])
        server.register_tenant("lo", other, tier=0)
        futs = [server.submit_stream("hi", _bufs(P, 340, w), steps=6),
                server.submit_stream("lo", {"x0": _bufs(P, 341)["x0"], "w": w}, steps=6)]
        server.start()
        res = [_outcome(f) for f in futs]
        server.close()
        return res, server

    _, server = _both(run)
    order = [r["class_id"] for r in server.metrics.trace.snapshot()]
    assert order[:6] == [0, 1, 0, 0, 1, 0]
