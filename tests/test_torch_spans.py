"""The port's span recorder (``repro_torch.core.spans``): nesting and
``parent``, a request's ``rid`` from its submission to the step that
served it, the ring's bound, nothing recorded or built while off, Python
collections as ``python.gc`` spans, recording under a ``torch.profiler``
session alone, the schema check, and a hybrid MoE prefill's per-layer
expert rows (``prefill.moe``) and state bytes (``prefill.caches``)."""
import gc
import threading

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import TDG, spans
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving import RegionServer


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    yield
    spans.disable()


def _body(x, w):
    return torch.tanh(x @ w) * 0.5 + x


def _served(n=3, steps=2):
    """``n`` tenants of a one-task region, each a ``steps``-step stream,
    all admitted before the server starts; the server, closed."""
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(6, 6, generator=gen)
    server = RegionServer(max_batch=4, continuous=True, autostart=False)
    futs = []
    for i in range(n):
        tdg = TDG(f"spans[{i}]")
        tdg.add_task(_body, ins=["x", "w"], outs=["x"], name="t")
        server.register_tenant(f"t{i}", tdg)
        futs.append(server.submit_stream(f"t{i}", {"x": torch.randn(6, 6, generator=gen),
                                                    "w": w}, steps=steps))
    server.start()
    for f in futs:
        f.result(60)
    server.close()
    return server


def test_nesting_gives_each_span_its_parent_on_its_own_thread():
    spans.enable()
    with spans.span("outer", k=1) as outer:
        with spans.span("inner") as inner:
            pass
        other = []
        t = threading.Thread(target=lambda: other.append(spans.span("apart").__enter__()))
        t.start()
        t.join(10)
        assert not t.is_alive()
    recs = {r["name"]: r for r in spans.snapshot()}
    assert recs["outer"]["parent"] is None and recs["outer"]["args"] == {"k": 1}
    assert recs["inner"]["parent"] == outer.id == recs["outer"]["id"]
    assert recs["inner"]["id"] == inner.id
    assert recs["outer"]["t0"] <= recs["inner"]["t0"] <= recs["inner"]["t1"] \
        <= recs["outer"]["t1"]
    assert recs["inner"]["thread"] == threading.current_thread().name
    assert other[0].parent is None          # another thread's stack is its own
    spans.validate_spans(spans.snapshot())


def test_a_request_shares_its_rid_from_submission_to_its_step():
    spans.enable()
    server = _served(n=3, steps=1)
    recs = spans.snapshot()
    submitted = {r["args"]["rid"]: r for r in recs if r["name"] == "submit.key"}
    steps = [r for r in recs if r["name"] == "step"]
    assert len(submitted) == 3 and len(steps) == 1
    assert sorted(steps[0]["args"]["rids"]) == sorted(submitted)
    assert all(s["t1"] <= steps[0]["t0"] for s in submitted.values())
    assert steps[0]["args"]["occupancy"] == 3 and steps[0]["args"]["bucket"] >= 3
    assert server.stats()["graphs"]["evictions"] == 0


def test_the_ring_keeps_the_newest_records():
    spans.enable(capacity=5)
    for i in range(12):
        with spans.span("s", i=i):
            pass
    recs = [r for r in spans.snapshot() if r["name"] == "s"]
    assert [r["args"]["i"] for r in recs] == list(range(12 - len(recs), 12))
    assert len(spans.snapshot()) == 5


def test_off_records_nothing_and_builds_no_span(monkeypatch):
    built = []
    monkeypatch.setattr(spans, "Span", lambda name, args: built.append(name) or spans.NOOP)
    assert spans.span("x", a=1) is spans.NOOP
    with spans.span("x") as s:
        assert not s
        s.set(a=2)
    _served()
    assert built == [] and spans.snapshot() == []
    assert spans._on_gc not in gc.callbacks


def test_python_gc_is_recorded_while_on_and_unhooked_by_disable():
    spans.enable()
    with spans.span("work") as work:
        gc.collect()
    recs = [r for r in spans.snapshot() if r["name"] == "python.gc"]
    assert recs and recs[-1]["args"]["generation"] == 2
    assert recs[-1]["parent"] == work.id and recs[-1]["t1"] >= recs[-1]["t0"]
    spans.disable()
    assert spans._on_gc not in gc.callbacks
    gc.collect()
    assert spans.snapshot() == []


def test_a_profiler_session_alone_records_spans_as_ranges():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("under.profiler", n=2):
            torch.ones(4).add_(1)
        assert spans._on_gc not in gc.callbacks   # collections only after enable()
    recs = [r for r in spans.snapshot() if r["name"] == "under.profiler"]
    assert len(recs) == 1 and recs[0]["args"] == {"n": 2}
    assert any(e.name == "under.profiler" for e in prof.events())
    assert spans.span("after") is spans.NOOP     # the session ended: off again
    assert spans._on_gc not in gc.callbacks


GOOD = {"id": 1, "parent": None, "name": "step", "thread": "t", "t0": 1.0, "t1": 2.0,
        "args": {"rids": [1, 2], "class_id": 0, "region": "r"}}


@pytest.mark.parametrize("bad", [
    {k: v for k, v in GOOD.items() if k != "t1"},          # a field missing
    {**GOOD, "extra": 1},                                  # a field not in the schema
    {**GOOD, "id": True},                                  # bool is no id
    {**GOOD, "parent": 1.5},
    {**GOOD, "t0": 3.0},                                   # ends before it starts
    {**GOOD, "args": {"x": 1.5}},                          # args: ints, strings, int lists
    {**GOOD, "args": {"x": "s" * 200}},
    {**GOOD, "args": {"x": [1, "a"]}},
    "not a dict",
])
def test_span_schema_rejects_malformed_records(bad):
    spans.validate_spans([GOOD])
    with pytest.raises(ValueError):
        spans.validate_spans([GOOD, bad])


#: A tiny Granite-like hybrid: Mamba, attention, Mamba layers, each with an
#: MoE of 8 experts, top-2, of which experts 2-5 are held, dropless (capacity
#: factor experts / top-k).
HYBRID = ModelConfig(
    name="hybrid-moe-tiny", family="hybrid", num_layers=3, d_model=32, num_heads=2,
    num_kv_heads=1, head_dim=16, d_ff=16, vocab_size=256,
    layer_types=("mamba", "attention", "mamba"), attn_scale=1 / 16, rope_theta=0.0,
    num_experts=8, top_k=2, moe_d_ff=16, num_shared_experts=1, shared_d_ff=24,
    experts_held=4, expert_offset=2, capacity_factor=8 / 2, ssm_state=8, ssm_headdim=16,
    ssm_chunk=8, tie_embeddings=True, dtype="float32")


def _hybrid_prefill(monkeypatch, tokens=11, max_len=20):
    """Prefill the tiny hybrid; the experts each MoE layer's router chose."""
    model = M.init_params(HYBRID, torch.Generator().manual_seed(3))
    chosen, route = [], MOE.route

    def spy(p, cfg, xt):
        out = route(p, cfg, xt)
        chosen.append(out[2])
        return out

    monkeypatch.setattr(MOE, "route", spy)
    toks = torch.randint(2, 256, (1, tokens), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, caches, _ = M.prefill(model, HYBRID, {"tokens": toks}, max_len)
    return chosen, caches


def test_prefill_records_expert_rows_and_state_bytes(monkeypatch):
    spans.enable()
    chosen, caches = _hybrid_prefill(monkeypatch)
    recs = {r["name"]: r for r in spans.snapshot()}
    held = [int(((c >= 2) & (c < 6)).sum()) for c in chosen]      # experts 2-5
    assert recs["prefill.moe"]["args"] == {"routed": held, "rows": [4 * 11] * 3}
    assert recs["prefill.moe"]["parent"] == recs["prefill"]["id"]
    # 2 Mamba layers: conv history (K-1, d_inner + 2N) and SSD state (H, P, N);
    # 1 attention layer: K and V (L, Hkv, hd) and the slots' positions
    ssm = 2 * 4 * (3 * (64 + 16) + 4 * 16 * 8)
    kv = 4 * (2 * 20 * 16) + 4 * 20
    assert recs["prefill.caches"]["args"] == {"ssm_bytes": ssm, "kv_bytes": kv}
    assert M.state_bytes(caches) == {"ssm_bytes": ssm, "kv_bytes": kv}
    spans.validate_spans(spans.snapshot())


def test_prefill_counts_nothing_while_spans_are_off(monkeypatch):
    def refuse():
        raise AssertionError("tally opened with spans off")

    monkeypatch.setattr(MOE, "tally", refuse)
    monkeypatch.setattr(M, "state_bytes", lambda caches: refuse())
    _hybrid_prefill(monkeypatch)
    assert spans.snapshot() == [] and getattr(MOE._counts, "rows", None) is None
