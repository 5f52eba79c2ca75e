"""The port's cost model against ``repro.core.costmodel``.

Exact where the reference is pure Python: ``CostModel.decide`` on the same
``ClassCost`` (the whole decision matrix, reasons included), the plan keys,
``fit_boundaries`` / ``pow2_boundaries`` and ``BucketTuner``'s observations
and summaries. The probe differs by design (FlopCounterMode on meta
tensors, not XLA's cost analysis), so ``measure()`` is held to being sane:
positive for a matrix product, unknown flops for an elementwise body,
unmeasured for a payload it cannot run. Also: each batcher plan interns
apart, the kill switch shares the static entry, and adaptive replay is
bit-exact against static replay.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro_torch.core import (TDG, ReplayExecutor, clear_intern_cache,  # noqa: E402
                              fusion_plan, intern_stats, lower_tdg)
from repro_torch.core import costmodel as cm  # noqa: E402

# (flops, bytes) per member, size: every branch of the matrix and its edges
COSTS = [
    (None, None, 8),                      # unmeasured
    (4.0, 16.0, 8),                       # below break-even
    (32.0, 16.0, 8),                      # exactly at break-even
    (64e3, 256 * 1024, 8),                # memory-bound, cache-resident member
    (256e3, 2 * 1024 * 1024, 8),          # memory-bound, member too large
    (1e3, 4 * 1024, 8),                   # memory-bound, whole batch resident
    (1e6, 1e4, 8),                        # compute-bound
    (None, 4096.0, 4),                    # unknown flops (an elementwise body)
    (1e3, None, 4),                       # unknown bytes
    (512.0, 512 * 1024, 1),               # a class of one
    (1e5, 1e5, 3),                        # intensity exactly at the ridge
]


@pytest.mark.parametrize("flops,nbytes,size", COSTS)
def test_decide_matches_reference(flops, nbytes, size):
    unmeasured = flops is None and nbytes is None
    mine = cm.CostModel().decide(
        cm.UNMEASURED if unmeasured else cm.ClassCost(flops, nbytes), size)
    want = jcm.CostModel().decide(
        jcm.UNMEASURED if unmeasured else jcm.ClassCost(flops, nbytes), size)
    assert (mine.batcher, mine.reason, mine.size) == (want.batcher, want.reason, want.size)
    assert mine.describe() == want.describe()


@pytest.mark.parametrize("kw", [{}, {"ridge": 4.0}, {"map_member_bytes": 1024,
                                                     "unroll_flops": 1e4}])
def test_thresholds_and_fingerprint_match_reference(kw):
    mine, want = cm.CostModel(**kw), jcm.CostModel(**kw)
    assert mine.fingerprint() == want.fingerprint()
    for flops, nbytes, size in COSTS[1:]:
        a = mine.decide(cm.ClassCost(flops, nbytes), size)
        b = want.decide(jcm.ClassCost(flops, nbytes), size)
        assert (a.batcher, a.reason) == (b.batcher, b.reason)


class TestProbe:
    def test_matmul_measures_positive_cost(self):
        m = cm.CostModel()
        spec = torch.empty(32, 32, device="meta")
        cost = m.measure(lambda a, b: a @ b, [spec, spec])
        assert cost.source == "measured"
        assert cost.flops == 2 * 32 ** 3
        assert cost.bytes_accessed == 3 * 32 * 32 * 4     # two inputs, one output
        assert cost.intensity and cost.intensity > 0

    def test_real_tensors_probe_on_meta(self):
        m = cm.CostModel()
        x = torch.randn(16, 16)
        cost = m.measure(lambda a: torch.tanh(a @ a.T) + a, [x])
        assert cost.flops == 2 * 16 ** 3 and cost.bytes_accessed == 2 * 16 * 16 * 4

    def test_elementwise_body_has_unknown_flops(self):
        cost = cm.CostModel().measure(lambda x: x * 2.0 + 1.0, [torch.zeros(64)])
        assert cost.flops is None and cost.bytes_accessed == 2 * 64 * 4
        # an unknown count never unrolls or maps: the static vmap plan
        assert cm.CostModel().decide(cost, size=8).batcher == "vmap"

    def test_probe_cached_per_payload_and_signature(self):
        m = cm.CostModel()
        fn = lambda x: x @ x  # noqa: E731
        m.measure(fn, [torch.zeros(8, 8)])
        m.measure(fn, [torch.zeros(8, 8, device="meta")])
        assert m.probes == 2        # the device is part of the signature
        m.measure(fn, [torch.zeros(8, 8)])
        assert m.probes == 2
        m.measure(fn, [torch.zeros(16, 16)])
        assert m.probes == 3

    def test_probe_failure_degrades_to_unmeasured(self):
        m = cm.CostModel()

        def boom(x):
            raise ValueError("cannot run on meta")

        assert m.measure(boom, [torch.zeros(4)]) is cm.UNMEASURED
        assert m.probe_failures == 1

    def test_host_readback_is_unmeasured(self):
        # .item() has no value on a meta tensor: the probe cannot count it
        m = cm.CostModel()
        assert m.measure(lambda x: x * x.sum().item(), [torch.ones(4)]) is cm.UNMEASURED

    def test_probe_launches_nothing(self):
        from repro_torch.kernels import ops, rmsnorm
        before = rmsnorm.launches
        cost = cm.CostModel().measure(lambda x, w: ops.rmsnorm(x, w),
                                      [torch.ones(4, 8), torch.ones(8)])
        assert cost.bytes_accessed == (2 * 4 * 8 + 8) * 4
        assert rmsnorm.launches == before


class TestPlanKey:
    def test_static_plans_pass_through(self):
        assert cm.plan_key("vmap") == jcm.plan_key("vmap") == "vmap"
        assert cm.plan_key("map") == jcm.plan_key("map") == "map"

    def test_adaptive_plan_key_matches_reference(self):
        assert cm.plan_key("auto") == f"auto/{cm.default_model().fingerprint()}"
        assert cm.plan_key("auto") == jcm.plan_key("auto")

    def test_kill_switch_collapses_auto_to_vmap(self, monkeypatch):
        monkeypatch.setenv(cm.ADAPTIVE_ENV, "0")
        assert cm.ADAPTIVE_ENV == "REPRO_TORCH_ADAPTIVE"
        assert cm.resolve_batcher("auto") == "vmap"
        assert cm.plan_key("auto") == "vmap"
        monkeypatch.setenv(cm.ADAPTIVE_ENV, "1")
        assert cm.resolve_batcher("auto") == "auto"

    def test_invalid_args_are_loud(self):
        with pytest.raises(ValueError, match="batcher"):
            cm.resolve_batcher("scan")
        with pytest.raises(ValueError, match="adaptive"):
            cm.adaptive_enabled("maybe")


def _grid_tdg(n_tasks=6, dim=16):
    tdg = TDG("cmgrid")

    def body(x):
        return torch.tanh(x @ x.T) + x

    for t in range(n_tasks):
        tdg.add_task(body, inouts=[f"x{t}"], name=f"t{t}")
    rng = np.random.default_rng(7)
    bufs = {f"x{t}": torch.from_numpy(rng.standard_normal((dim, dim)).astype(np.float32))
            for t in range(n_tasks)}
    return tdg, bufs


class TestInternIsolation:
    def test_each_plan_gets_its_own_entry(self):
        tdg, bufs = _grid_tdg()
        clear_intern_cache()
        outs = {b: lower_tdg(tdg, batcher=b)(dict(bufs)) for b in ("vmap", "map", "auto")}
        stats = intern_stats()
        assert stats["misses"] == 3 and stats["entries"] == 3
        for b in ("vmap", "map", "auto"):
            lower_tdg(tdg, batcher=b)
        assert intern_stats()["hits"] == 3
        for b in ("map", "auto"):
            for k in outs["vmap"]:
                torch.testing.assert_close(outs[b][k], outs["vmap"][k], atol=2e-5, rtol=2e-5)
        clear_intern_cache()

    def test_kill_switch_shares_the_static_entry(self, monkeypatch):
        tdg, _ = _grid_tdg()
        clear_intern_cache()
        monkeypatch.setenv(cm.ADAPTIVE_ENV, "0")
        lower_tdg(tdg, batcher="vmap")
        lower_tdg(tdg, batcher="auto")
        stats = intern_stats()
        assert (stats["misses"], stats["hits"], stats["entries"]) == (1, 1, 1)
        clear_intern_cache()


def _mixed(mod, xp):
    """One region with three payload kinds in one wave (the reference's)."""
    tdg = mod.TDG("mixed")

    def mm(a, w):
        return a @ w

    def relax(x):
        return 0.25 * (xp.roll(x, 1, 0) + xp.roll(x, -1, 0)
                       + xp.roll(x, 1, 1) + xp.roll(x, -1, 1))

    def nudge(x):
        return x + 0.5

    for i in range(4):
        tdg.add_task(mm, ins=[f"a{i}", "w"], outs=[f"y{i}"])
        tdg.add_task(relax, ins=[f"h{i}"], outs=[f"g{i}"])
        tdg.add_task(nudge, ins=[f"s{i}"], outs=[f"t{i}"])
    rng = np.random.default_rng(3)
    bufs = {}
    for i in range(4):
        bufs[f"a{i}"] = rng.standard_normal((64, 64)).astype(np.float32)
        bufs[f"h{i}"] = rng.standard_normal((128, 128)).astype(np.float32)
        bufs[f"s{i}"] = rng.standard_normal((2,)).astype(np.float32)
    bufs["w"] = rng.standard_normal((64, 64)).astype(np.float32)
    return tdg, bufs


class TestAdaptivePlan:
    def test_mixed_region_decisions(self):
        tdg, bufs = _mixed(tcore, torch)
        plan = fusion_plan(tdg, {k: torch.from_numpy(v) for k, v in bufs.items()},
                           batcher="auto")
        by_payload = {tdg.tasks[c.tids[0]].fn.__name__: c for c in plan.classes}
        mm = by_payload["mm"]
        assert mm.batcher == "vmap" and mm.flops == 2 * 64 ** 3
        assert mm.bytes_accessed == 3 * 64 * 64 * 4
        assert "compute-bound" in mm.reason
        # FlopCounterMode counts no elementwise op: unknown flops, vmap
        for name in ("relax", "nudge"):
            c = by_payload[name]
            assert c.batcher == "vmap" and c.flops is None and c.fused
        # the same measured numbers decide as the reference decides
        want = jcm.CostModel().decide(jcm.ClassCost(mm.flops, mm.bytes_accessed), 4)
        assert (mm.batcher, mm.reason) == (want.batcher, want.reason)

    def test_adaptive_replay_bit_exact_vs_static(self):
        tdg, bufs = _mixed(tcore, torch)
        tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
        out_static = ReplayExecutor(tdg, batcher="vmap").run(dict(tb))
        out_auto = ReplayExecutor(tdg, batcher="auto").run(dict(tb))
        assert set(out_static) == set(out_auto)
        for k in out_static:
            assert torch.equal(out_static[k], out_auto[k])

    def test_matches_reference_values(self):
        tdg, bufs = _mixed(tcore, torch)
        jtdg, _ = _mixed(jcore, jnp)
        got = ReplayExecutor(tdg).run({k: torch.from_numpy(v) for k, v in bufs.items()})
        want = jcore.ReplayExecutor(jtdg, batcher="vmap").run(
            {k: jnp.asarray(v) for k, v in bufs.items()})
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2e-5, atol=2e-5)

    def test_executor_plan_key_is_pinned_at_construction(self, monkeypatch):
        tdg, _ = _grid_tdg()
        ex = ReplayExecutor(tdg, batcher="auto")
        assert ex.plan_key.startswith("auto/")
        monkeypatch.setenv(cm.ADAPTIVE_ENV, "0")
        assert ReplayExecutor(tdg, batcher="auto").plan_key == "vmap"
        assert ex.plan_key.startswith("auto/")


class TestBuckets:
    @pytest.mark.parametrize("seed", range(6))
    def test_fit_boundaries_match_reference(self, seed):
        rng = np.random.default_rng(seed)
        hist = {int(v): int(c) for v, c in zip(rng.integers(1, 33, size=8),
                                               rng.integers(0, 20, size=8))}
        for k in (1, 2, 3, 8):
            assert cm.fit_boundaries(hist, k) == jcm.fit_boundaries(hist, k)

    @pytest.mark.parametrize("hist,k,want", [
        ({5: 40, 12: 30, 3: 10, 16: 5}, 8, [3, 5, 12, 16]),
        ({4: 10, 7: 1}, 1, [7]),
        ({1: 100, 4: 1}, 8, [4]),
        ({1: 100}, 8, []),
        ({}, 8, [])])
    def test_fit_boundaries_cases(self, hist, k, want):
        assert cm.fit_boundaries(hist, k) == want

    @pytest.mark.parametrize("max_batch", [1, 2, 5, 16, 33])
    def test_pow2_boundaries_match_reference(self, max_batch):
        assert cm.pow2_boundaries(max_batch) == jcm.pow2_boundaries(max_batch)

    @pytest.mark.parametrize("kw", [
        {"adaptive": False, "window": 4},
        {"adaptive": True, "window": 4},
        {"adaptive": True, "window": 4, "max_new_buckets": 1},
        {"adaptive": True, "window": 64, "drift_pad_fraction": 0.1}])
    def test_tuner_matches_reference(self, kw):
        rng = np.random.default_rng(11)
        occ = [int(o) for o in rng.choice([1, 3, 5, 6, 9, 12], size=150)]
        mine, want = cm.BucketTuner(16, **kw), jcm.BucketTuner(16, **kw)
        assert [mine.observe(o) for o in occ] == [want.observe(o) for o in occ]
        assert mine.summary() == want.summary()
        assert [mine.bucket_for(o) for o in range(1, 40)] == \
            [want.bucket_for(o) for o in range(1, 40)]

    def test_tuner_kill_switch_pins_pow2(self, monkeypatch):
        monkeypatch.setenv(cm.ADAPTIVE_ENV, "0")
        t = cm.BucketTuner(16, window=2)
        assert t.adaptive is False
        for _ in range(8):
            assert t.observe(5) is False
        assert t.boundaries == cm.pow2_boundaries(16)
