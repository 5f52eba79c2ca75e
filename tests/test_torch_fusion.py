"""The port's wave-fused lowering against ``repro.core.fuse`` / ``lower``.

The same graphs (chain, diamond, wave grid, pipeline grid, MoE-style
fan-out) are built with both packages over the same numpy inputs:

* fused == unfused == eager inside the port at the reference's tolerance
  (2e-5), and every task's output equal to the reference's task fed the
  same inputs, at 2e-5;
* ``FusionPlan.summary()`` equals the reference's exactly under
  ``batcher="vmap"`` and ``"map"``, offline (``plan``) and as applied
  (``last_plan``);
* an isomorphic-wave graph dispatches O(waves) matrix products, not
  O(tasks) (the port's counterpart of the reference's jaxpr count);
* interning, fallbacks and the kill switch behave as the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import lower as lower_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 2e-5


class _Jax:
    tanh = staticmethod(jnp.tanh)
    gelu = staticmethod(jax.nn.gelu)            # tanh approximation
    asarray = staticmethod(lambda a: jnp.asarray(a))


class _Torch:
    tanh = staticmethod(torch.tanh)
    gelu = staticmethod(lambda x: torch.nn.functional.gelu(x, approximate="tanh"))
    asarray = staticmethod(lambda a: torch.from_numpy(np.ascontiguousarray(a)))


def _mm_for(xp):
    def mm(x):
        return xp.tanh(x @ x.T) @ x * 0.5 + x
    return mm


def _grid(mod, xp, n_waves=4, n_tasks=8, dim=8):
    """``n_waves`` waves of ``n_tasks`` isomorphic chains (paper Listing 1)."""
    mm = _mm_for(xp)
    tdg = mod.TDG(f"grid{n_waves}x{n_tasks}")
    for w in range(n_waves):
        for t in range(n_tasks):
            tdg.add_task(mm, inouts=[f"x{t}"], name=f"t{w}.{t}")
    rng = np.random.default_rng(0)
    return tdg, {f"x{t}": rng.standard_normal((dim, dim)).astype(np.float32)
                 for t in range(n_tasks)}


def _chain(mod, xp, n=12):
    tdg = mod.TDG("chain")
    fn = lambda x: x * 1.001 + 0.5  # noqa: E731
    for i in range(n):
        tdg.add_task(fn, inouts=["x"], name=f"c{i}")
    return tdg, {"x": np.arange(6.0, dtype=np.float32)}


def _diamond(mod, xp):
    tdg = mod.TDG("diamond")
    tdg.add_task(lambda x: x + 1.0, ins=["x"], outs=["a"])
    tdg.add_task(lambda a: a * 2.0, ins=["a"], outs=["b"])
    tdg.add_task(lambda a: a * 3.0, ins=["a"], outs=["c"])
    tdg.add_task(lambda b, c: b + c, ins=["b", "c"], outs=["y"])
    return tdg, {"x": np.arange(5.0, dtype=np.float32)}


def _pipeline(mod, xp, stages=4, micro=6, dim=8):
    """Forward pipeline over real matmul payloads (isomorphic diagonals)."""
    mm = _mm_for(xp)
    tdg = mod.TDG("pipe")
    for m in range(micro):
        for s in range(stages):
            ins = [f"act[{m},{s-1}]"] if s > 0 else [f"in{m}"]
            tdg.add_task(mm, ins=ins, outs=[f"act[{m},{s}]"], name=f"F[{m},{s}]")
    rng = np.random.default_rng(1)
    return tdg, {f"in{m}": rng.standard_normal((dim, dim)).astype(np.float32)
                 for m in range(micro)}


def _moe(mod, xp, n_blocks=6, dim=16):
    """Shared router weight + heterogeneous expert payloads."""
    tdg = mod.TDG("moe")
    rng = np.random.default_rng(2)

    def route(x, w):
        return x @ w

    def expert_a(x):
        return xp.gelu(x) * 1.5

    def expert_b(x):
        return xp.tanh(x) - 0.1 * x

    for b in range(n_blocks):
        tdg.add_task(route, ins=[f"x{b}", "w"], outs=[f"r{b}"])
        tdg.add_task(expert_a if b % 2 == 0 else expert_b, ins=[f"r{b}"], outs=[f"e{b}"])
    tdg.add_task(lambda *es: sum(es), ins=[f"e{b}" for b in range(n_blocks)], outs=["y"])
    bufs = {f"x{b}": rng.standard_normal((4, dim)).astype(np.float32)
            for b in range(n_blocks)}
    bufs["w"] = rng.standard_normal((dim, dim)).astype(np.float32)
    return tdg, bufs


GRAPHS = {"grid": _grid, "chain": _chain, "diamond": _diamond,
          "pipeline": _pipeline, "moe": _moe}


def _both(graph, **kw):
    """(port TDG, torch buffers), (reference TDG, jax buffers) of one graph."""
    tdg, bufs = GRAPHS[graph](T, _Torch, **kw)
    jtdg, jbufs = GRAPHS[graph](J, _Jax, **kw)
    return ((tdg, {k: _Torch.asarray(v) for k, v in bufs.items()}),
            (jtdg, {k: _Jax.asarray(v) for k, v in jbufs.items()}))


def _stepwise(tdg, jtdg, bufs, tol=TOL):
    """Each task of the reference's TDG, fed the port's inputs to that task,
    returns the port task's output within ``tol``. (End to end, f32 rounding
    differences between the frameworks' elementwise functions grow through
    chained nonlinear stages: the pipeline graph's four ends 1e-3 apart on
    values near 60, while within each package fused == unfused == eager.)"""
    env = dict(bufs)
    for tid in T.topo_order(tdg):
        t, jt = tdg.tasks[tid], jtdg.tasks[tid]
        assert (t.ins, t.outs) == (jt.ins, jt.outs)
        args = [env[s] for s in t.ins]
        out = t.fn(*args)
        want = jt.fn(*[jnp.asarray(a.numpy()) for a in args])
        outs, wants = (out, want) if len(t.outs) > 1 else ((out,), (want,))
        for s, o, w in zip(t.outs, outs, wants):
            np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=tol, atol=tol)
            env[s] = o
    return env


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _fresh():
    T.reset_registry()
    T.clear_intern_cache()
    yield
    T.reset_registry()
    T.clear_intern_cache()


class TestParity:
    @pytest.mark.parametrize("graph", sorted(GRAPHS))
    def test_fused_vs_unfused_vs_eager(self, graph):
        (tdg, bufs), (jtdg, jbufs) = _both(graph)
        eager = T.EagerExecutor(tdg, n_workers=3).run(dict(bufs))
        unfused = T.lower_tdg(tdg, fuse=False, intern=False)(dict(bufs))
        fused = T.lower_tdg(tdg, fuse=True, intern=False)(dict(bufs))
        _close(unfused, eager)
        _close(fused, eager)
        env = _stepwise(tdg, jtdg, bufs)
        _close(fused, {k: env[k] for k in fused})

    @pytest.mark.parametrize("graph", ["grid", "pipeline", "moe"])
    def test_map_batcher_parity(self, graph):
        (tdg, bufs), (jtdg, jbufs) = _both(graph)
        vmapped = T.lower_tdg(tdg, fuse=True, intern=False)(dict(bufs))
        mapped = T.lower_tdg(tdg, fuse=True, intern=False, batcher="map")(dict(bufs))
        _close(mapped, vmapped)
        jmapped = J.lower_tdg(jtdg, fuse=True, intern=False, batcher="map")(dict(jbufs))
        _close(jmapped, J.lower_tdg(jtdg, fuse=True, intern=False)(dict(jbufs)))

    def test_grad_through_fused(self):
        def build(mod):
            tdg = mod.TDG("g")
            double = lambda x: x * 2.0  # noqa: E731  (one payload: one class)
            for t in range(4):
                tdg.add_task(double, ins=[f"x{t}"], outs=[f"y{t}"])
            tdg.add_task(lambda *ys: sum((y ** 2).sum() for y in ys),
                         ins=[f"y{t}" for t in range(4)], outs=["l"])
            return tdg

        f = T.lower_tdg(build(T), jit=False, fuse=True)
        x = torch.arange(3.0)
        g = torch.func.grad(lambda x: f({f"x{t}": x for t in range(4)})["l"])(x)
        assert f.last_plan.fused_classes == 1
        jf = J.lower_tdg(build(J), jit=False, fuse=True)
        jg = jax.grad(lambda x: jf({f"x{t}": x for t in range(4)})["l"])(jnp.arange(3.0))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg))
        np.testing.assert_allclose(g.numpy(), 4 * 8.0 * np.arange(3.0))

    @pytest.mark.parametrize("graph", sorted(GRAPHS))
    @pytest.mark.parametrize("batcher", ["vmap", "map"])
    def test_plan_summary_matches_reference(self, graph, batcher):
        (tdg, bufs), (jtdg, jbufs) = _both(graph)
        assert (T.fusion_plan(tdg, bufs, batcher=batcher).summary()
                == J.fusion_plan(jtdg, jbufs, batcher=batcher).summary())
        assert T.fusion_plan(tdg).summary() == J.fusion_plan(jtdg).summary()
        f = T.fused_tdg_as_function(tdg, batcher=batcher)
        jf = J.fused_tdg_as_function(jtdg, batcher=batcher)
        f(dict(bufs))
        jf(dict(jbufs))
        assert f.last_plan.summary() == jf.last_plan.summary()


class TestWaveAnalysis:
    def test_plan_groups_isomorphic_waves(self):
        tdg, bufs = _grid(T, _Torch, n_waves=5, n_tasks=7)
        plan = T.fusion_plan(tdg, bufs)
        assert plan.num_tasks == 35 and plan.num_waves == 5
        assert plan.num_classes == 5
        assert plan.fused_tasks == 35 and plan.fused_fraction == 1.0

    def test_plan_respects_shapes(self):
        tdg = T.TDG("shapes")
        fn = lambda x: x + 1.0  # noqa: E731
        for t in range(4):
            tdg.add_task(fn, ins=[f"a{t}"], outs=[f"b{t}"])
        bufs = {f"a{t}": torch.zeros((4,) if t < 2 else (8,)) for t in range(4)}
        plan = T.fusion_plan(tdg, bufs)
        assert plan.num_classes == 2
        assert sorted(c.size for c in plan.classes) == [2, 2]

    def test_plan_takes_meta_buffers_and_closure_constants(self):
        const = torch.ones(3)
        tdg = T.TDG("meta")
        scale = lambda x: x * const  # noqa: E731
        for t in range(3):
            tdg.add_task(scale, ins=[f"x{t}"], outs=[f"y{t}"])
        plan = T.fusion_plan(tdg, {f"x{t}": torch.empty(3, device="meta") for t in range(3)})
        assert plan.num_classes == 1 and plan.fused_tasks == 3

    def test_structural_plan_without_shapes(self):
        tdg, _ = _grid(T, _Torch, n_waves=2, n_tasks=4)
        plan = T.fusion_plan(tdg)
        assert plan.num_classes == 2 and plan.fused_tasks == 8

    def test_classify_shared_arg_positions(self):
        from repro_torch.core.fuse import value_signature
        tdg = T.TDG("sh")
        fn = lambda x, w: x * w  # noqa: E731
        for t in range(3):
            tdg.add_task(fn, ins=[f"x{t}", "w"], outs=[f"y{t}"])
        env = {f"x{t}": torch.zeros(3) for t in range(3)}
        env["w"] = torch.zeros(3)
        [cls] = T.classify_wave(tdg, 0, T.topo_waves(tdg)[0],
                                lambda s: value_signature(env[s]))
        assert cls.shared == (False, True)    # w broadcasts, x stacks
        out = T.fused_tdg_as_function(tdg)({**env, "w": torch.arange(3.0)})
        assert torch.equal(out["y0"], torch.zeros(3))

    def test_heterogeneous_wave_falls_back(self):
        tdg, bufs = _moe(T, _Torch)
        f = T.fused_tdg_as_function(tdg)
        f({k: _Torch.asarray(v) for k, v in bufs.items()})
        plan = f.last_plan
        assert plan.fused_classes >= 1
        assert plan.fused_tasks < plan.num_tasks  # the reduce task is unrolled
        assert sum(c.size for c in plan.classes) == plan.num_tasks

    def test_unbatchable_class_falls_back_and_says_so(self):
        def data_dependent(x):
            return x * 2 if bool(x.sum() > 0) else x   # no vmap rule for bool()

        tdg = T.TDG("dd")
        for t in range(3):
            tdg.add_task(data_dependent, ins=[f"x{t}"], outs=[f"y{t}"])
        f = T.fused_tdg_as_function(tdg)
        out = f({f"x{t}": torch.full((2,), t - 1.0) for t in range(3)})
        [cls] = f.last_plan.classes
        assert not cls.fused and cls.reason == "trace fallback: payload not batchable"
        assert torch.equal(out["y2"], torch.full((2,), 2.0))

    def test_identical_input_class_evaluates_once(self):
        calls = []

        def fn(x):
            calls.append(1)
            return x + 1.0

        tdg = T.TDG("allshared")
        for t in range(5):
            tdg.add_task(fn, ins=["x"], outs=[f"y{t}"])
        out = T.fused_tdg_as_function(tdg)({"x": torch.arange(3.0)})
        assert len(calls) == 1
        for t in range(5):
            assert torch.equal(out[f"y{t}"], torch.arange(3.0) + 1)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm)
                and not args[0].is_meta):    # the cost model probes on meta
            self.n += 1
        return func(*args, **(kwargs or {}))


class TestDispatchCount:
    def test_isomorphic_wave_graph_dispatches_o_waves_products(self):
        n_waves, n_tasks = 4, 16
        tdg, bufs = _grid(T, _Torch, n_waves=n_waves, n_tasks=n_tasks)
        bufs = {k: _Torch.asarray(v) for k, v in bufs.items()}
        counts = {}
        for fuse in (False, True):
            f = T.lower_tdg(tdg, jit=False, fuse=fuse)
            with _CountProducts() as c:
                f(dict(bufs))
            counts[fuse] = c.n
        # two products a body: O(tasks) unrolled, O(waves) fused
        assert counts == {False: 2 * n_waves * n_tasks, True: 2 * n_waves}

    def test_fallback_when_explicit_order(self):
        tdg, bufs = _grid(T, _Torch, 2, 4)
        bufs = {k: _Torch.asarray(v) for k, v in bufs.items()}
        f = T.lower_tdg(tdg, order=list(range(tdg.num_tasks)), jit=False)
        assert not hasattr(f, "last_plan")     # the unrolled form was chosen
        _close(f(dict(bufs)), T.lower_tdg(tdg, fuse=False, intern=False)(dict(bufs)), 1e-6)

    def test_fuse_env_var_kill_switch(self, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_FUSE", "0")
        assert not T.fuse_enabled("auto")
        tdg, _ = _grid(T, _Torch, 2, 4)
        assert not hasattr(T.lower_tdg(tdg, jit=False), "last_plan")
        monkeypatch.setenv("REPRO_TORCH_FUSE", "1")
        assert T.fuse_enabled("auto")
        assert T.fuse_enabled(True) and not T.fuse_enabled(False)
        with pytest.raises(ValueError, match="fuse"):
            T.fuse_enabled("sometimes")


class TestInterning:
    def test_structurally_identical_tdgs_share_executable(self):
        def fn(x):
            return x * 2.0 + 1.0

        def mk(name):
            tdg = T.TDG(name)
            for _ in range(3):
                for t in range(4):
                    tdg.add_task(fn, inouts=[f"b{t}"])
            return tdg

        bufs = {f"b{t}": torch.arange(4.0) + t for t in range(4)}
        o1 = T.ReplayExecutor(mk("A")).run(dict(bufs))
        o2 = T.ReplayExecutor(mk("B")).run(dict(bufs))
        stats = T.intern_stats()
        assert (stats["misses"], stats["hits"], stats["entries"]) == (1, 1, 1)
        _close(o1, o2, 0)

    def test_regions_with_renamed_slots_intern(self):
        def payload(x):
            return x * 3.0 - 1.0

        @T.taskgraph
        def region_a(g, u0, u1):
            g.task(payload, inouts=["u0"])
            g.task(payload, inouts=["u1"])

        @T.taskgraph
        def region_b(g, v0, v1):
            g.task(payload, inouts=["v0"])
            g.task(payload, inouts=["v1"])

        region_a(u0=torch.ones(3), u1=torch.zeros(3))    # record
        region_b(v0=torch.ones(3), v1=torch.zeros(3))    # record
        T.clear_intern_cache()
        ra = region_a(u0=torch.ones(3), u1=torch.zeros(3))   # replay: miss
        rb = region_b(v0=torch.ones(3), v1=torch.zeros(3))   # replay: hit
        stats = T.intern_stats()
        assert (stats["misses"], stats["hits"]) == (1, 1)
        assert torch.equal(ra["u0"], rb["v0"])

    def test_different_payloads_do_not_collide(self):
        def mk(fn):
            tdg = T.TDG("p")
            tdg.add_task(fn, inouts=["x"])
            tdg.add_task(fn, inouts=["x"])
            return tdg

        o1 = T.ReplayExecutor(mk(lambda x: x + 1.0)).run({"x": torch.zeros(3)})
        o2 = T.ReplayExecutor(mk(lambda x: x - 1.0)).run({"x": torch.zeros(3)})
        assert T.intern_stats()["entries"] == 2
        assert torch.equal(o1["x"], torch.full((3,), 2.0))
        assert torch.equal(o2["x"], torch.full((3,), -2.0))

    def test_different_structure_does_not_collide(self):
        def fn(x):
            return x + 1.0

        t1, t2 = T.TDG("a"), T.TDG("b")
        t1.add_task(fn, inouts=["x"])
        t2.add_task(fn, inouts=["x"])
        t2.add_task(fn, inouts=["x"])
        T.ReplayExecutor(t1).run({"x": torch.zeros(2)})
        T.ReplayExecutor(t2).run({"x": torch.zeros(2)})
        assert T.intern_stats()["entries"] == 2

    def test_explicit_intern_rules(self):
        tdg, _ = _chain(T, _Torch, 3)
        with pytest.raises(ValueError, match="intern=True"):
            T.lower_tdg(tdg, order=[0, 1, 2], intern=True)
        # the port shares an uncaptured callable too (the server's), keyed
        # apart from the captured one; the reference requires jit here
        T.lower_tdg(tdg, jit=False, intern=True)
        T.lower_tdg(tdg, jit=False, intern=True)
        T.lower_tdg(tdg)
        stats = T.intern_stats()
        assert (stats["misses"], stats["hits"], stats["entries"]) == (2, 1, 2)
        jtdg, _ = _chain(J, _Jax, 3)
        with pytest.raises(ValueError, match="intern=True"):
            J.lower_tdg(jtdg, jit=False, intern=True)

    def test_intern_cache_is_lru_bounded(self, monkeypatch):
        monkeypatch.setattr(lower_mod, "_INTERN_CAP", 2)
        for i in range(4):
            tdg = T.TDG(f"lru{i}")
            tdg.add_task(lambda x, i=i: x + float(i), inouts=["x"])
            T.ReplayExecutor(tdg).run({"x": torch.zeros(2)})   # fresh closure: miss
        stats = T.intern_stats()
        assert stats["entries"] <= 2 and stats["evictions"] == 2

    def test_kernel_mode_keys_intern_cache(self):
        def fn(x, w):
            return ops.rmsnorm(x, w)

        def mk():
            tdg = T.TDG("k")
            for t in range(2):
                tdg.add_task(fn, ins=[f"x{t}", "w"], outs=[f"y{t}"])
            return tdg

        bufs = {f"x{t}": torch.ones((4, 8)) for t in range(2)}
        bufs["w"] = torch.ones(8)
        a = T.ReplayExecutor(mk(), kernel_mode="ref").run(dict(bufs))
        b = T.ReplayExecutor(mk(), kernel_mode="auto").run(dict(bufs))
        assert T.intern_stats()["entries"] == 2  # the substrate is part of the key
        _close(a, b, 0)

    @pytest.mark.parametrize("kw", [{"fuse": False}, {"min_class_size": 3},
                                    {"batcher": "map"}, {"donate_slots": ["x0"]}])
    def test_lowering_options_key_like_reference(self, kw):
        def script(mod, xp):
            mod.clear_intern_cache()
            tdg, _ = _grid(mod, xp, 2, 3)
            mod.lower_tdg(tdg)
            mod.lower_tdg(tdg)
            mod.lower_tdg(tdg, **kw)
            mod.lower_tdg(tdg, **kw)
            return {k: mod.intern_stats()[k] for k in ("hits", "misses", "entries")}

        assert script(T, _Torch) == script(J, _Jax) == {"hits": 2, "misses": 2, "entries": 2}
        J.clear_intern_cache()


class TestRegionFusionIntegration:
    def test_region_replay_fused_matches_record(self):
        mm = _mm_for(_Torch)

        @T.taskgraph
        def region(g, **kw):
            for t in range(6):
                g.task(mm, inouts=[f"x{t}"], name=f"a{t}")
            for t in range(6):
                g.task(mm, inouts=[f"x{t}"], name=f"b{t}")

        rng = np.random.default_rng(3)
        bufs = {f"x{t}": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
                for t in range(6)}
        rec = region(**bufs)
        rep = region(**bufs)
        assert region.records == 1 and region.replays == 1
        _close(rep, rec)
        assert region.schedule_summary()["fusion"]["fused_tasks"] == 12

    def test_fuse_false_region_still_works(self):
        @T.taskgraph(fuse=False)
        def region(g, x):
            g.task(lambda x: x + 1.0, inouts=["x"])
            g.task(lambda x: x * 2.0, inouts=["x"])

        o1 = region(x=torch.arange(4.0))
        o2 = region(x=torch.arange(4.0))
        assert torch.equal(o1["x"], o2["x"])


class TestListScheduleRegression:
    def test_no_dead_pending_path(self):
        (tdg, _), (jtdg, _) = _both("pipeline", stages=3, micro=4)
        sched = T.list_schedule(tdg, 3)
        assert T.validate_execution_order(tdg, sched.order())
        assert len(sched.start_time) == tdg.num_tasks
        jsched = J.list_schedule(jtdg, 3)
        assert sched.worker_tasks == jsched.worker_tasks
        assert sched.order() == jsched.order()

    def test_forged_cycle_rejected_loudly(self):
        tdg, _ = _diamond(T, _Torch)
        tdg.preds[0].add(3)     # forge a cycle bypassing add_task
        tdg.succs[3].add(0)
        with pytest.raises((ValueError, RuntimeError)):
            T.list_schedule(tdg, 2)


class TestGraphKey:
    """What keys a captured CUDA graph: checked on the CPU side of the key."""

    def test_small_cpu_tensors_and_scalars_key_by_value(self):
        from repro_torch.core.lower import _graph_key
        a = _graph_key([torch.tensor(2.0), 3, "x"])
        assert a == _graph_key([torch.tensor(2.0), 3, "x"])
        assert a != _graph_key([torch.tensor(3.0), 3, "x"])
        assert a != _graph_key([torch.tensor(2.0), 4, "x"])

    def test_modules_key_by_identity(self):
        from repro_torch.core.lower import _graph_key
        lin = torch.nn.Linear(2, 2)
        assert _graph_key([lin]) == _graph_key([lin])
        assert _graph_key([lin]) != _graph_key([torch.nn.Linear(2, 2)])

    @pytest.mark.parametrize("leaf", [torch.zeros(17), bytearray(b"ab")])
    def test_what_a_graph_cannot_bake_in_raises(self, leaf):
        from repro_torch.core.lower import _graph_key
        with pytest.raises(T.GraphCaptureError, match="capture"):
            _graph_key([leaf])
