"""The port's record-and-replay regions against ``repro.core.record``.

The reference's cases (``tests/test_record_replay.py``) on the port, with
the same builders recorded by both packages from the same numpy inputs:
equal TDGs (edges, record-time dependency lookups, schedule summaries),
replay values at the reference's tolerance, the replay cache keyed by
signature and kernel mode, ``build_static`` on meta tensors, the registry's
refusal of a second region at one source location, non-recurrent regions,
and the output restriction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels import registry as kreg  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh():
    T.reset_registry()
    yield
    T.reset_registry()


def _mk_region(mod, nowait=False):
    @mod.taskgraph(nowait=nowait)
    def region(g, x, a):
        g.task(lambda x, a: x * a, ins=["x", "a"], outs=["y"], name="scale")
        g.task(lambda y: y + 1.0, ins=["y"], outs=["z"], name="shift")
        g.task(lambda y, z: (y * z).sum(), ins=["y", "z"], outs=["w"], name="dot")
    return region


def _inputs(n=4, a=3.0):
    x = np.arange(float(n), dtype=np.float32)
    return ({"x": torch.from_numpy(x), "a": torch.tensor(a)},
            {"x": jnp.asarray(x), "a": jnp.float32(a)})


def _edges(tdg):
    return sorted((e.src, e.dst, e.kind.value, e.slot) for e in tdg.edges)


def test_first_call_records_then_replays():
    region, jregion = _mk_region(T), _mk_region(J)
    tb, jb = _inputs()
    o1 = region(**tb)
    assert region.records == 1 and region.replays == 0
    o2 = region(**tb)
    assert region.replays == 1
    jo = jregion(**jb)
    for k in jo:
        np.testing.assert_allclose(o1[k].numpy(), o2[k].numpy(), rtol=1e-6)
        np.testing.assert_allclose(o2[k].numpy(), np.asarray(jo[k]), rtol=1e-6)
    assert _edges(region.tdg) == _edges(jregion.tdg)
    assert region.tdg.dep_lookups() == jregion.tdg.dep_lookups()


def test_replay_new_data_changes_result():
    region = _mk_region(T)
    region(**_inputs(a=1.0)[0])
    o = region(**_inputs(a=2.0)[0])                     # fill_data path
    assert torch.equal(o["y"], 2.0 * torch.arange(4.0))


def test_replay_cache_per_signature():
    region = _mk_region(T)
    region(**_inputs()[0])
    region(**_inputs()[0])
    region(**_inputs(n=8)[0])                           # new shape -> new entry
    assert len(region._replay_cache) == 2


def test_replay_cache_keyed_by_kernel_mode():
    """Flipping the kernel mode between replays re-lowers, not a stale entry."""
    region = _mk_region(T)
    region(**_inputs()[0])                              # record
    with kreg.kernel_mode_scope("ref"):
        region(**_inputs()[0])
    with kreg.kernel_mode_scope("auto"):
        region(**_inputs()[0])
    assert len(region._replay_cache) == 2
    assert {key[1] for key in region._replay_cache} == {"ref", "auto"}


def test_replay_cache_keyed_by_batcher_plan(monkeypatch):
    region = _mk_region(T)
    region(**_inputs()[0])
    region(**_inputs()[0])
    monkeypatch.setenv("REPRO_TORCH_ADAPTIVE", "0")
    region(**_inputs()[0])
    assert sorted(key[2].split("/")[0] for key in region._replay_cache) == ["auto", "vmap"]


def test_static_build_on_meta_matches_recorded():
    rec = _mk_region(T)
    rec(**_inputs()[0])

    @T.taskgraph(name="static_twin")
    def twin(g, x, a):
        g.task(lambda x, a: x * a, ins=["x", "a"], outs=["y"])
        g.task(lambda y: y + 1.0, ins=["y"], outs=["z"])
        g.task(lambda y, z: (y * z).sum(), ins=["y", "z"], outs=["w"])

    tdg = twin.build_static(x=torch.empty(4, device="meta"),
                            a=torch.empty((), device="meta"))
    assert twin.static and tdg is twin.tdg
    assert (tdg.num_tasks, tdg.num_edges) == (rec.tdg.num_tasks, rec.tdg.num_edges)
    assert _edges(tdg) == _edges(rec.tdg)
    jtwin = J.taskgraph(name="static_twin")(twin.build_fn)
    jtwin.build_static(x=jax.ShapeDtypeStruct((4,), jnp.float32),
                       a=jax.ShapeDtypeStruct((), jnp.float32))
    assert _edges(tdg) == _edges(jtwin.tdg)
    assert tdg.dep_lookups() == jtwin.tdg.dep_lookups()
    o = twin(**_inputs(a=1.0)[0])                       # replay, no recording
    assert twin.records == 0 and twin.replays == 1
    np.testing.assert_allclose(o["w"].item(), float((np.arange(4.0) * (np.arange(4.0) + 1)).sum()))


@pytest.mark.parametrize("payload", ["cholesky_ex", "solve_triangular", "closure"])
def test_static_build_runs_payloads_on_meta(payload):
    """The workloads' payloads evaluate on meta tensors: the factorization
    and the triangular solve have meta kernels, and a payload closing over a
    real tensor (nbody's particle positions) is evaluated with it on meta."""
    const = torch.randn(8, 3)
    fns = {"cholesky_ex": lambda a: torch.linalg.cholesky_ex(a).L,
           "solve_triangular": lambda a: torch.linalg.solve_triangular(a, a.T, upper=False),
           "closure": lambda a: (a[:, None, :3] - const[None]).sum(1)}

    @T.taskgraph(name=f"meta_{payload}")
    def region(g, a):
        g.task(fns[payload], ins=["a"], outs=["b"])

    tdg = region.build_static(a=torch.empty(8, 8, device="meta"))
    assert tdg.num_tasks == 1
    o = region(a=torch.eye(8) * 4.0)
    assert o["b"].shape[0] == 8 and not o["b"].is_meta


def test_source_location_registry():
    region = _mk_region(T)
    assert region.source_location in T.registry()
    # same source location twice -> non-conforming (paper §4.1 rule 3)
    with pytest.raises(ValueError, match="already registered"):
        T.TaskGraphRegion(region.build_fn, name=region.name)
    T.reset_registry()
    assert T.registry() == {}
    T.TaskGraphRegion(region.build_fn, name=region.name)


def test_non_recurrent_runs_without_tdg():
    @T.taskgraph(recurrent=False)
    def once(g, x):
        g.task(lambda x: x + 1, ins=["x"], outs=["y"])

    o = once(x=torch.zeros(()))
    assert once.tdg is None             # Algorithm 4.1 line 23 fallback
    assert o["y"].item() == 1.0
    o = once(x=torch.ones(()))
    assert once.tdg is None and once.records == 0 and o["y"].item() == 2.0


def test_outputs_restriction():
    @T.taskgraph(outputs=("z",))
    def region(g, x):
        g.task(lambda x: x * 2, ins=["x"], outs=["y"])
        g.task(lambda y: y + 1, ins=["y"], outs=["z"])

    assert set(region(x=torch.ones(()))) == {"z"}
    assert set(region(x=torch.ones(()))) == {"z"}


def test_schedule_summary_matches_reference():
    region, jregion = _mk_region(T), _mk_region(J)
    region(**_inputs()[0])
    jregion(**_inputs()[1])
    s = region.schedule_summary()
    assert s["tasks"] == 3 and s["waves"] == 3 and s["roots"] == 1
    assert s["dep_lookups_at_record"] > 0
    assert s == jregion.schedule_summary()


def test_as_function_and_nowait():
    region = _mk_region(T, nowait=True)
    tb, _ = _inputs()
    rec = region(**tb)
    f = region.as_function()
    out = f(dict(tb))
    for k in rec:
        assert torch.equal(out[k], rec[k])
    g = torch.func.grad(lambda x: f({"x": x, "a": tb["a"]})["w"])(tb["x"])
    # w = sum(x a (x a + 1)): dw/dx = a (2 x a + 1)
    np.testing.assert_allclose(g.numpy(), (3.0 * (2 * np.arange(4.0) * 3.0 + 1)), rtol=1e-6)


def test_warmup_waits_for_serialization():
    """``warmup`` and ``aot_compile`` export the replay program ahead of
    time (serialization is ported): installed in the replay cache, the next
    call replays it with no lowering, equal to the reference's warmed
    region; the executor's program equals its lowered replay bitwise."""
    region, jregion = _mk_region(T), _mk_region(J)
    tb, jb = _inputs()
    region(**tb)
    jregion(**jb)
    aot = region.warmup(**tb)
    jaot = jregion.warmup(**jb)
    assert isinstance(aot, T.AotExecutable) and aot.fused == jaot.fused
    assert aot.input_specs == {"x": ((4,), "float32"), "a": ((), "float32")}
    assert aot.cost_analysis["bytes accessed"] > 0
    out, jout = region(**tb), jregion(**jb)
    assert region.replays == 1
    for k in jout:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-6)
    ex = T.ReplayExecutor(region.tdg)
    prog = ex.aot_compile(tb)
    want = T.ReplayExecutor(region.tdg).run(dict(tb))
    got = ex.run(dict(tb))
    assert prog.matches(tb) and not prog.matches({"x": torch.zeros(5), "a": tb["a"]})
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="custom order"):
        T.ReplayExecutor(region.tdg, order=[0, 1, 2]).aot_compile(tb)
