"""The port's executors and schedules against ``repro.core``.

``EagerExecutor`` must count exactly what the reference counts on the same
TDG (tasks executed, queue operations, steals, dependency resolutions) for
every scheduler policy, and give the same values as ``ReplayExecutor``; the
pure-Python schedules (placement, critical path, list scheduling, the
pipeline TDG and 1F1B streams) must equal the reference's exactly. Also the
reference's cases of ``tests/test_executor.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402


def _inc(x):
    return x * 1.0001 + 1.0


def _add(a, b):
    return a + b


def _listing1(mod, series: int, tasks: int):
    """Paper Listing 1: ``series`` waves of ``tasks`` independent chains."""
    tdg = mod.TDG("listing1")
    for s in range(series):
        for t in range(tasks):
            tdg.add_task(_inc, inouts=[f"x{t}"], name=f"t{s}.{t}")
    return tdg


def _random(mod, seed: int, n: int = 40):
    """Random clauses over 10 slots, with cost hints."""
    rng = np.random.default_rng(seed)
    tdg = mod.TDG(f"random{seed}")
    for i in range(n):
        fn = (_inc, _add)[int(rng.integers(2))]
        ins = [f"s{j}" for j in rng.choice(10, size=fn.__code__.co_argcount, replace=False)]
        tdg.add_task(fn, ins=ins, outs=[f"s{int(rng.integers(10))}"],
                     cost_hint=float(rng.integers(1, 9)), name=f"r{i}")
    return tdg


GRAPHS = {"listing1_3x5": lambda m: _listing1(m, 3, 5),
          "listing1_1x16": lambda m: _listing1(m, 1, 16),
          "listing1_4x6": lambda m: _listing1(m, 4, 6),
          **{f"random{s}": (lambda m, _s=s: _random(m, _s)) for s in range(3)}}


def _bufs(tdg):
    rng = np.random.default_rng(0)
    x = {s: rng.standard_normal(3).astype(np.float32) for s in tdg.input_slots}
    return ({s: torch.from_numpy(v) for s, v in x.items()},
            {s: jnp.asarray(v) for s, v in x.items()})


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("workers,central,steal,rr", [
    (1, False, True, True), (3, False, True, True), (8, False, True, True),
    (3, True, True, True), (4, False, False, True), (4, False, True, False),
    (2, True, False, False)])
def test_exec_stats_match_reference(graph, workers, central, steal, rr):
    tdg, jtdg = GRAPHS[graph](T), GRAPHS[graph](J)
    tb, jb = _bufs(tdg)
    kw = dict(n_workers=workers, central_queue=central, steal=steal, round_robin_roots=rr)
    ex = T.EagerExecutor(tdg, **kw)
    jex = J.EagerExecutor(jtdg, **kw)
    out, jout = ex.run(dict(tb)), jex.run(dict(jb))
    count = ("tasks_executed", "queue_ops", "steals", "dep_resolutions")
    assert {k: getattr(ex.stats, k) for k in count} == {k: getattr(jex.stats, k) for k in count}
    assert ex.stats.dep_resolutions == tdg.num_edges
    for k in jout:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-6)


class TestEquivalence:
    @pytest.mark.parametrize("central", [False, True])
    @pytest.mark.parametrize("workers", [1, 3, 8])
    def test_eager_matches_replay(self, central, workers):
        tdg = _listing1(T, 3, 5)
        bufs = {f"x{t}": torch.tensor(float(t)) for t in range(5)}
        r1 = T.EagerExecutor(tdg, n_workers=workers, central_queue=central).run(dict(bufs))
        r2 = T.ReplayExecutor(tdg).run(dict(bufs))
        for k in r2:
            torch.testing.assert_close(r1[k], r2[k], rtol=1e-6, atol=0)

    def test_matmul_dag(self):
        rng = np.random.default_rng(42)
        a, b = (rng.standard_normal((8, 8)).astype(np.float32) for _ in range(2))

        def build(mod):
            tdg = mod.TDG("mm")
            tdg.add_task(lambda a, b: a @ b, ins=["a", "b"], outs=["ab"])
            tdg.add_task(lambda a: a.T, ins=["a"], outs=["at"])
            tdg.add_task(lambda ab, at: ab + at, ins=["ab", "at"], outs=["out"])
            return tdg

        tdg = build(T)
        bufs = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
        r1 = T.EagerExecutor(tdg, 2).run(dict(bufs))
        r2 = T.ReplayExecutor(tdg).run(dict(bufs))
        want = J.ReplayExecutor(build(J)).run({"a": jnp.asarray(a), "b": jnp.asarray(b)})
        torch.testing.assert_close(r1["out"], r2["out"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r2["out"].numpy(), np.asarray(want["out"]),
                                   rtol=2e-5, atol=2e-5)

    def test_grad_through_lowered(self):
        tdg = T.TDG("g")
        tdg.add_task(lambda x: x * 2.0, ins=["x"], outs=["y"])
        tdg.add_task(lambda y: (y ** 2).sum(), ins=["y"], outs=["l"])
        f = T.lower_tdg(tdg, jit=False)
        g = torch.func.grad(lambda x: f({"x": x})["l"])(torch.arange(3.0))
        torch.testing.assert_close(g, 8.0 * torch.arange(3.0))


class TestSchedulerPolicies:
    def test_root_distribution_spreads_load(self):
        ex = T.EagerExecutor(_listing1(T, 1, 16), n_workers=4, round_robin_roots=True)
        ex.run({f"x{t}": torch.tensor(float(t)) for t in range(16)})
        assert ex.stats.steals == 0      # everyone starts with its own queue

    def test_vanilla_single_owner_steals(self):
        ex = T.EagerExecutor(_listing1(T, 1, 16), n_workers=4, round_robin_roots=False)
        ex.run({f"x{t}": torch.tensor(float(t)) for t in range(16)})
        assert ex.stats.tasks_executed == 16 and ex.stats.steals > 0

    def test_replay_cache_hit(self):
        rep = T.ReplayExecutor(_listing1(T, 2, 3))
        bufs = {f"x{t}": torch.tensor(float(t)) for t in range(3)}
        rep.run(dict(bufs))
        rep.run(dict(bufs))
        assert rep.replays == 2 and len(rep._cache) == 1

    def test_kernel_mode_is_pinned_at_construction(self):
        from repro_torch.kernels import registry as kreg
        seen = []

        def probe(x):
            seen.append(kreg.kernel_mode())
            return x + 1

        tdg = T.TDG("pin")
        tdg.add_task(probe, inouts=["x"])
        with kreg.kernel_mode_scope("ref"):
            ex = T.ReplayExecutor(tdg)
        assert ex.kernel_mode == "ref"
        ex.run({"x": torch.zeros(1)})
        assert seen == ["ref"]
        T.clear_intern_cache()

    @pytest.mark.parametrize("donate", [("state",), ("state", "g"), ("g",), ()])
    def test_donation_slots(self, donate):
        """Donation against the reference's ``_jit_with_donation``: the same
        outputs; a donated slot keys its own interned entry; on the CPU the
        region runs as it is, so the donated input is left alone (on the card
        it becomes the graph's buffer: ``test_torch_cuda.py``)."""
        T.clear_intern_cache()
        graphs = {}
        for mod in (J, T):
            g = mod.TDG("d")
            g.add_task(_add, ins=["state", "g"], outs=["state"])
            g.add_task(_inc, ins=["g"], outs=["h"])
            graphs[mod] = g
        rng = np.random.default_rng(21)
        state, g = rng.standard_normal(4).astype(np.float32), np.ones(4, np.float32)
        want = J.lower_tdg(graphs[J], donate_slots=donate)(
            {"state": jnp.asarray(state), "g": jnp.asarray(g)})
        bufs = {"state": torch.from_numpy(state.copy()), "g": torch.from_numpy(g.copy())}
        fn = T.lower_tdg(graphs[T], donate_slots=donate)
        out = fn(dict(bufs))
        for k in want:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=2e-5,
                                       atol=2e-5)
        assert torch.equal(bufs["state"], torch.from_numpy(state))
        slot_map = T.structure_signature(graphs[T])[1]
        assert fn.graph_replay.donate == frozenset(slot_map[s] for s in donate)
        T.lower_tdg(graphs[T])
        assert T.intern_stats()["entries"] == (1 if not donate else 2)
        T.clear_intern_cache()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_schedules_match_reference(graph):
    tdg, jtdg = GRAPHS[graph](T), GRAPHS[graph](J)
    for n in (1, 3, 4):
        assert T.wave_placement(tdg, n) == J.wave_placement(jtdg, n)
        assert T.round_robin_assign(tdg.roots(), n, start=1) == \
            J.round_robin_assign(jtdg.roots(), n, start=1)
        s, js = T.list_schedule(tdg, n), J.list_schedule(jtdg, n)
        assert (s.worker_tasks, s.start_time, s.finish_time, s.makespan) == \
            (js.worker_tasks, js.start_time, js.finish_time, js.makespan)
        assert s.order() == js.order()
        assert T.validate_execution_order(tdg, s.order())
    assert T.critical_path(tdg) == J.critical_path(jtdg)
    assert T.critical_path(tdg, lambda t: 1.0) == J.critical_path(jtdg, lambda t: 1.0)
    assert T.work(tdg) == J.work(jtdg)
    assert T.parallelism(tdg) == J.parallelism(jtdg)


def test_list_schedule_load_balance():
    sched = T.list_schedule(_listing1(T, 1, 32), 4)
    sizes = [len(w) for w in sched.worker_tasks]
    assert max(sizes) - min(sizes) <= 1
    assert sched.makespan == pytest.approx(8.0)


@pytest.mark.parametrize("stages,micro,backward", [(2, 3, True), (4, 6, True),
                                                   (3, 5, False), (1, 1, True)])
def test_pipeline_schedules_match_reference(stages, micro, backward):
    p, jp = T.pipeline_tdg(stages, micro, backward), J.pipeline_tdg(stages, micro, backward)
    assert p.summary() == jp.summary() and p.region == jp.region
    assert sorted((e.src, e.dst, e.kind.value, e.slot) for e in p.edges) == \
        sorted((e.src, e.dst, e.kind.value, e.slot) for e in jp.edges)
    assert [(t.name, t.metadata) for t in p.tasks] == [(t.name, t.metadata) for t in jp.tasks]
    assert T.topo_waves(p) == J.topo_waves(jp)
    assert T.one_f_one_b_order(stages, micro) == J.one_f_one_b_order(stages, micro)


def test_chain_series_matches_reference():
    from repro.core.tdg import chain_series as jchain
    from repro_torch.core.tdg import chain_series
    t, j = T.TDG("c"), J.TDG("c")
    chain_series(t, [_inc, _inc, _inc], slot="h")
    jchain(j, [_inc, _inc, _inc], slot="h")
    assert t.summary() == j.summary()
    assert [x.name for x in t.tasks] == [x.name for x in j.tasks] == ["h.0", "h.1", "h.2"]


def test_abstract_leaf_is_a_meta_tensor():
    from repro.core.tdg import abstract_leaf as jleaf
    from repro_torch.core.tdg import abstract_leaf
    for v in (np.zeros((2, 3), np.float32), 3.0):
        spec = jleaf(jnp.asarray(v))
        leaf = abstract_leaf(torch.as_tensor(v))
        assert leaf.is_meta and tuple(leaf.shape) == tuple(spec.shape)
        assert str(leaf.dtype).replace("torch.", "") == str(spec.dtype)
    meta = torch.empty(4, device="meta")
    assert abstract_leaf(meta) is meta
