"""The port's TDG serialization and warm artifact (``repro_torch.core.
serialize``, ``lower.aot_compile_tdg``) against ``repro.core.serialize``.

The TDG JSON is the reference's schema: a file written by either package
loads in the other, with the same topological waves and replays equal on
the same numpy inputs. The reference's ``test_serialize.py`` cases run on
the port. The warm artifact is an exported replay program: it equals the
lowered replay bitwise, agrees with the reference's AOT executable on the
same inputs, refuses another device topology before ``torch.export.load``
is touched, and the server counts what it could not hydrate.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import serialize as jser  # noqa: E402
from repro.serving.demo import DEMO_REGISTRY as J_DEMO  # noqa: E402
from repro.serving.demo import demo_region as j_demo_region  # noqa: E402
from repro_torch.core import (TDG, ReplayExecutor, TaskFnRegistry, TopologyMismatch,  # noqa: E402
                              aot_compile_tdg, executable_from_bytes,
                              executable_to_bytes, load_tdg, load_warm, lower_tdg,
                              save_tdg, tdg_from_dict, tdg_to_dict, topo_waves,
                              topology_fingerprint, warmup_and_save)
from repro_torch.serving import RegionServer  # noqa: E402
from repro_torch.serving.cluster import WorkerNode  # noqa: E402
from repro_torch.serving.demo import DEMO_REGISTRY, demo_region  # noqa: E402

REG = TaskFnRegistry()


@REG.register()
def scale2(x):
    return x * 2.0


@REG.register()
def addone(x):
    return x + 1.0


@REG.register("dotsum")
def dot(x, y):
    return (x * y).sum()


def _graph():
    tdg = TDG("ser")
    tdg.add_task(scale2, ins=["a"], outs=["b"], name="s")
    tdg.add_task(addone, ins=["b"], outs=["c"], name="p", cost_hint=2.0, stage=1)
    tdg.add_task(dot, ins=["b", "c"], outs=["d"], name="d")
    return tdg


def _demo_bufs(seed, dim=6):
    rng = np.random.default_rng(seed)
    arrs = {k: rng.standard_normal((dim, dim)).astype(np.float32) for k in ("x0", "x1", "w")}
    return ({k: torch.from_numpy(v) for k, v in arrs.items()},
            {k: jnp.asarray(v) for k, v in arrs.items()})


def _close(got: dict, want: dict, tol=2e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=tol, atol=tol)


# ------------------------------------------------ the reference's seven cases

def test_roundtrip_structure_and_replay(tmp_path):
    tdg = _graph()
    f = tmp_path / "region.tdg.json"
    save_tdg(tdg, f, REG)
    tdg2 = load_tdg(f, REG)
    assert tdg2.num_tasks == tdg.num_tasks
    assert tdg2.num_edges == tdg.num_edges
    assert topo_waves(tdg2) == topo_waves(tdg)
    assert tdg2.tasks[1].metadata == {"stage": 1}
    assert tdg2.tasks[1].cost_hint == 2.0
    bufs = {"a": torch.arange(4.0)}
    r1 = ReplayExecutor(tdg).run(dict(bufs))
    r2 = ReplayExecutor(tdg2).run(dict(bufs))
    for k in r1:
        np.testing.assert_allclose(r1[k].numpy(), r2[k].numpy(), rtol=1e-6)


def test_loaded_tdg_supports_add_task(tmp_path):
    """The rebuilt dependency table resolves add_task after a load."""
    tdg = _graph()
    f = tmp_path / "grow.tdg.json"
    save_tdg(tdg, f, REG)
    tdg2 = load_tdg(f, REG)
    before = tdg2.num_edges
    t = tdg2.add_task(addone, ins=["d"], outs=["e"], name="post-load")
    assert tdg2.preds[t.tid] == {2}
    assert tdg2.num_edges == before + 1
    fresh = _graph()
    fresh.add_task(addone, ins=["d"], outs=["e"], name="post-load")
    bufs = {"a": torch.arange(4.0)}
    r1 = ReplayExecutor(fresh).run(dict(bufs))
    r2 = ReplayExecutor(tdg2).run(dict(bufs))
    np.testing.assert_allclose(r1["e"].numpy(), r2["e"].numpy(), rtol=1e-6)


def test_loaded_tdg_war_edges_still_resolve(tmp_path):
    tdg = _graph()
    f = tmp_path / "war.tdg.json"
    save_tdg(tdg, f, REG)
    tdg2 = load_tdg(f, REG)
    t = tdg2.add_task(scale2, ins=["a"], outs=["b"], name="rewrite-b")
    kinds = {(e.src, e.kind.value) for e in tdg2.edges if e.dst == t.tid}
    assert (2, "war") in kinds
    assert (0, "waw") in kinds


def test_unregistered_payload_rejected():
    tdg = TDG("bad")
    tdg.add_task(lambda x: x, ins=["a"], outs=["b"])
    with pytest.raises(ValueError, match="not registered"):
        tdg_to_dict(tdg, REG)


def test_unknown_symbol_rejected():
    data = tdg_to_dict(_graph(), REG)
    data["tasks"][0]["fn"] = "nonexistent"
    with pytest.raises(KeyError):
        tdg_from_dict(data, REG)


def test_version_gate():
    data = tdg_to_dict(_graph(), REG)
    data["version"] = 99
    with pytest.raises(ValueError, match="version"):
        tdg_from_dict(data, REG)


def test_duplicate_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        REG.register("scale2")(lambda x: x)


# ------------------------------------------------ JSON across the packages

@pytest.mark.parametrize("waves,width", [(2, 2), (3, 4)])
def test_reference_json_loads_in_the_port_and_back(tmp_path, waves, width):
    jtdg = j_demo_region("x[0]", waves=waves, width=width)
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jser.save_tdg(jtdg, jpath, J_DEMO)
    ttdg = load_tdg(jpath, DEMO_REGISTRY)
    save_tdg(ttdg, tpath, DEMO_REGISTRY)
    assert jpath.read_text() == tpath.read_text()          # same schema, same bytes
    jback = jser.load_tdg(tpath, J_DEMO)
    assert topo_waves(ttdg) == J.topo_waves(jtdg) == J.topo_waves(jback)
    assert sorted((e.src, e.dst, e.kind.value, e.slot) for e in ttdg.edges) == \
        sorted((e.src, e.dst, e.kind.value, e.slot) for e in jtdg.edges)
    rng = np.random.default_rng(waves * 10 + width)
    arrs = {f"x{s}": rng.standard_normal((5, 5)).astype(np.float32) for s in range(width)}
    arrs["w"] = rng.standard_normal((5, 5)).astype(np.float32)
    got = ReplayExecutor(ttdg).run({k: torch.from_numpy(v) for k, v in arrs.items()})
    want = J.ReplayExecutor(jback).run({k: jnp.asarray(v) for k, v in arrs.items()})
    _close({k: v.numpy() for k, v in got.items()}, want)


# ------------------------------------------------ the warm artifact

def test_aot_program_equals_lowered_replay_bitwise_and_roundtrips():
    tdg = demo_region("aot[0]", waves=3, width=3)
    tb, _ = _demo_bufs(1)
    tb["x2"] = torch.from_numpy(np.random.default_rng(2).standard_normal((6, 6)).astype(np.float32))
    aot = aot_compile_tdg(tdg, tb)
    want = lower_tdg(tdg)(dict(tb))
    got = aot(tb)
    hydrated = executable_from_bytes(executable_to_bytes(aot), device="cpu")
    again = hydrated(tb)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(again[k], want[k])
    assert aot.fused and hydrated.fused
    assert hydrated.input_specs == aot.input_specs == {k: ((6, 6), "float32") for k in tb}
    assert hydrated.cost_analysis == aot.cost_analysis and aot.flops > 0
    assert aot.bytes_accessed == 4 * 36 * 4 + 3 * 36 * 4       # inputs + outputs
    # the artifact holds the program, not the buffers it was exported on
    assert hydrated.program.example_inputs is None
    big = {k: torch.zeros(256, 256) for k in tb}
    assert len(executable_to_bytes(aot_compile_tdg(tdg, big))) < 4 * 256 * 256 * 4


def test_hydrated_program_agrees_with_the_reference_aot(tmp_path):
    tb, jb = _demo_bufs(3)
    path = tmp_path / "warm.json"
    info = warmup_and_save(demo_region("w[0]"), tb, path, DEMO_REGISTRY)
    assert info["aot_path"] == str(path) + ".aot" and info["trace_seconds"] > 0
    tdg, aot = load_warm(path, DEMO_REGISTRY, device="cpu")
    assert aot is not None and tdg.num_tasks == 4
    jaot = J.aot_compile_tdg(jser.load_tdg(path, J_DEMO), jb)
    _close({k: v.numpy() for k, v in aot(tb).items()}, jaot(jb))


def test_topology_mismatch_raises_before_load_and_is_counted():
    tb, _ = _demo_bufs(4)
    data = executable_to_bytes(aot_compile_tdg(demo_region("topo[0]"), tb))
    blob = pickle.loads(data)
    assert blob["topology"] == topology_fingerprint("cpu")
    assert set(blob["topology"]) == {"platform", "device_kind", "device_count", "sm",
                                     "torch", "cuda", "mesh"}
    for skew in ({"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "sm": "9.0"},
                 {"torch": "0.0.1"}, {"cuda": "0.0"}):
        bad = dict(blob, topology=dict(blob["topology"], **skew),
                   payload=b"not an exported program")   # never reached
        with pytest.raises(TopologyMismatch, match="re-lower"):
            executable_from_bytes(pickle.dumps(bad), device="cpu")
    # shipped to a worker: counted, and the tenant re-lowers and serves
    node = WorkerNode(DEMO_REGISTRY, device="cpu", max_batch=1)
    try:
        skewed = dict(blob, topology=dict(blob["topology"], torch="0.0.1"))
        reply = node._handle_register({
            "tenant": "t", "tdg": tdg_to_dict(demo_region("topo[0]"), DEMO_REGISTRY),
            "artifact": pickle.dumps(skewed)})
        assert reply["hydrated"] is False and "TopologyMismatch" in reply["hydrate_error"]
        m = node.server.metrics.snapshot()
        assert m["aot_topology_rejects"] == 1 and m["aot_hydrate_failures"] == 1
        out = node.server.serve("t", tb)
        _close({k: v.numpy() for k, v in out.items()},
               {k: v.numpy() for k, v in lower_tdg(demo_region("topo[0]"))(tb).items()})
    finally:
        node.server.close()
        node.listener.close()


def test_corrupt_sidecar_counts_hydrate_failure(tmp_path):
    tdg = demo_region("hf[0]")
    path = str(tmp_path / "hf.json")
    save_tdg(tdg, path, DEMO_REGISTRY)
    with open(path + ".aot", "wb") as f:
        f.write(b"garbage bytes")
    with RegionServer(max_batch=1, device="cpu") as server:
        server.register_tenant("hf", warm_path=path, fn_registry=DEMO_REGISTRY)
        tb, _ = _demo_bufs(5)
        out = server.serve("hf", tb)
        want = ReplayExecutor(tdg).run(dict(tb))
        for k in want:
            assert torch.equal(out[k], want[k])
        m = server.metrics.snapshot()
        assert m["aot_hydrate_failures"] == 1 and m["aot_served"] == 0


def test_missing_sidecar_is_not_a_failure(tmp_path):
    path = str(tmp_path / "nf.json")
    save_tdg(demo_region("nf[0]"), path, DEMO_REGISTRY)
    with RegionServer(max_batch=1, device="cpu") as server:
        server.register_tenant("nf", warm_path=path, fn_registry=DEMO_REGISTRY)
        assert server.metrics.snapshot()["aot_hydrate_failures"] == 0
    with pytest.raises(ValueError, match="exactly one"):
        RegionServer(device="cpu", autostart=False).register_tenant("x")
    with pytest.raises(ValueError, match="fn_registry"):
        RegionServer(device="cpu", autostart=False).register_tenant("x", warm_path=path)


def test_warm_path_hydrates_and_serves_without_lowering(tmp_path):
    from repro_torch.core import lower
    tb, _ = _demo_bufs(6)
    path = tmp_path / "warm.json"
    warmup_and_save(demo_region("wp[0]"), tb, path, DEMO_REGISTRY)
    lower.clear_intern_cache()
    with RegionServer(max_batch=1, device="cpu") as server:
        server.register_tenant("wp", warm_path=str(path), fn_registry=DEMO_REGISTRY)
        out = server.serve("wp", tb)
        other = {k: v + 1 for k, v in tb.items()}
        server.serve("wp", {"x0": other["x0"][:3], "x1": other["x1"][:3], "w": tb["w"]})
        st = server.stats()
    want = ReplayExecutor(demo_region("wp[0]")).run(dict(tb))
    for k in want:
        assert torch.equal(out[k], want[k])
    assert st["pool"]["hydrations"] == 1
    assert st["metrics"]["aot_served"] == 1           # the other shape is lowered
    assert st["intern"]["misses"] == 1


def test_server_warmup_installs_and_serves_the_program():
    tb, _ = _demo_bufs(7)
    with RegionServer(max_batch=1, device="cpu") as server:
        server.register_tenant("s", demo_region("s[0]"))
        report = server.warmup("s", tb)
        out = server.serve("s", tb)
        assert server.metrics.snapshot()["aot_served"] == 1
    assert report["fused"] and report["cost_analysis"]["flops"] > 0
    want = ReplayExecutor(demo_region("s[0]")).run(dict(tb))
    for k in want:
        assert torch.equal(out[k], want[k])
