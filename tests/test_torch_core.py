"""The port's TDG, schedules and replay lowering against the JAX reference.

The same graphs are built with both packages (same payload functions, same
clauses) and must give equal edges, region inputs/outputs, topological
orders, waves and canonical structure signatures; the structural intern
cache must count the same hits and misses. Also: the import rule of the
port (no ``jax``, no ``repro``), checked on the source.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import lower as jax_lower  # noqa: E402
from repro.core import schedule as jax_schedule  # noqa: E402
from repro.core import tdg as jax_tdg  # noqa: E402
from repro_torch.core import lower, schedule, tdg  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _double(x):
    return x * 2 + 1


def _add(a, b):
    return a + b


def _split(x):
    return x - 1, x + 1


def _chain(mod, region="chain"):
    g = mod.TDG(region)
    for i in range(4):
        g.add_task(_double, inouts=["x"], name=f"x.{i}")
    return g


def _diamond(mod, region="diamond"):
    g = mod.TDG(region)
    g.add_task(_double, ins=["a"], outs=["b"])
    g.add_task(_split, ins=["a"], outs=["c", "d"])
    g.add_task(_add, ins=["b", "c"], outs=["e"])
    g.add_task(_add, ins=["e", "d"], outs=["out"])
    return g


def _hazards(mod, region="hazards"):
    """RAW, WAR and WAW edges on shared slots."""
    g = mod.TDG(region)
    g.add_task(_double, ins=["x"], outs=["y"])
    g.add_task(_double, ins=["z"], outs=["x"])          # WAR on x
    g.add_task(_double, ins=["x"], outs=["y"])          # RAW x, WAW y
    g.add_task(_add, ins=["x", "y"], outs=["z"])        # WAR z
    return g


def _random(mod, seed, region="random"):
    rng = np.random.default_rng(seed)
    g = mod.TDG(region)
    fns = (_double, _add)
    for _ in range(20):
        fn = fns[rng.integers(2)]
        ins = [f"s{i}" for i in rng.choice(8, size=fn.__code__.co_argcount, replace=False)]
        g.add_task(fn, ins=ins, outs=[f"s{rng.integers(8)}"])
    return g


GRAPHS = [_chain, _diamond, _hazards] + [
    (lambda mod, region="random", _s=s: _random(mod, _s, region)) for s in range(4)]


def _edges(g):
    return sorted((e.src, e.dst, e.kind.value, e.slot) for e in g.edges)


@pytest.mark.parametrize("build", GRAPHS)
def test_graph_matches_reference(build):
    jg, tg = build(jax_tdg), build(tdg)
    assert _edges(tg) == _edges(jg)
    assert tg.input_slots == jg.input_slots
    assert tg.output_slots == jg.output_slots
    assert tg.roots() == jg.roots()
    assert tg.dep_lookups() == jg.dep_lookups()
    assert tg.summary() == jg.summary()
    assert schedule.topo_order(tg) == jax_schedule.topo_order(jg)
    assert schedule.topo_waves(tg) == jax_schedule.topo_waves(jg)
    jsig, jmap, jpay = jax_tdg.structure_signature(jg)
    tsig, tmap, tpay = tdg.structure_signature(tg)
    assert tsig == jsig and tmap == jmap and tpay == jpay
    order = schedule.topo_order(tg)
    assert schedule.validate_execution_order(tg, order)
    if tg.edges:
        assert not schedule.validate_execution_order(tg, order[::-1])
        assert (schedule.validate_execution_order(tg, order[::-1])
                == jax_schedule.validate_execution_order(jg, order[::-1]))


def test_signature_canonicalizes_slot_names():
    a = _diamond(tdg, "one")
    b = tdg.TDG("two")
    b.add_task(_double, ins=["p"], outs=["q"])
    b.add_task(_split, ins=["p"], outs=["r", "s"])
    b.add_task(_add, ins=["q", "r"], outs=["t"])
    b.add_task(_add, ins=["t", "s"], outs=["u"])
    assert tdg.structure_signature(a)[0] == tdg.structure_signature(b)[0]


@pytest.mark.parametrize("build", GRAPHS[:3])
def test_replay_matches_reference_values(build):
    jg, tg = build(jax_tdg), build(tdg)
    rng = np.random.default_rng(0)
    inputs = {s: rng.standard_normal(3).astype(np.float32) for s in tg.input_slots}
    want = jax_lower.tdg_as_function(jg)(inputs)
    got = lower.lower_tdg(tg)({s: torch.from_numpy(v) for s, v in inputs.items()})
    assert sorted(got) == sorted(want)
    for s in want:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]), rtol=1e-6)


def test_order_is_validated():
    g = _chain(tdg)
    with pytest.raises(ValueError, match="does not respect"):
        lower.tdg_as_function(g, order=[3, 2, 1, 0])
    with pytest.raises(ValueError, match="intern=True requires"):
        lower.lower_tdg(g, order=[0, 1, 2, 3], intern=True)
    out = lower.lower_tdg(g, order=[0, 1, 2, 3])({"x": torch.tensor(1.0)})
    assert out["x"].item() == 31.0


def test_intern_counts_match_reference():
    """Hits and misses of the structural cache, port vs JAX, on one script."""
    def script(mod, lower_mod, scope):
        lower_mod.clear_intern_cache()
        lower_mod.lower_tdg(_diamond(mod, "a"))                # miss
        lower_mod.lower_tdg(_diamond(mod, "b"))                # hit: same structure
        lower_mod.lower_tdg(_chain(mod))                       # miss: other structure
        lower_mod.lower_tdg(_chain(mod), donate_slots=["x"])   # miss: donation keys
        lower_mod.lower_tdg(_diamond(mod, "c"), outputs=["out"])   # miss: outputs key
        with scope():
            lower_mod.lower_tdg(_diamond(mod, "d"))            # miss: kernel mode keys
        lower_mod.lower_tdg(_diamond(mod, "e"), order=[0, 1, 2, 3])   # not interned
        return {k: lower_mod.intern_stats()[k] for k in ("hits", "misses", "entries")}

    from repro.kernels import registry as jax_registry
    want = script(jax_tdg, jax_lower, lambda: jax_registry.kernel_mode_scope("interpret"))
    got = script(tdg, lower, lambda: registry.kernel_mode_scope("ref"))
    assert got == want == {"hits": 1, "misses": 5, "entries": 5}
    jax_lower.clear_intern_cache()
    lower.clear_intern_cache()


def test_interned_lowering_pins_kernel_mode():
    seen = []

    def probe(x):
        seen.append(registry.kernel_mode())
        return x

    g = tdg.TDG("probe")
    g.add_task(probe, inouts=["x"])
    with registry.kernel_mode_scope("ref"):
        fn = lower.lower_tdg(g)
    fn({"x": torch.zeros(1)})
    assert seen == ["ref"]
    lower.clear_intern_cache()


def test_buffers_signature_of_tensors_and_modules():
    lin = torch.nn.Linear(4, 3)
    a = {"params": lin, "caches": [{"k": torch.zeros(2, 3)}], "n": 3}
    b = {"params": torch.nn.Linear(4, 3), "caches": [{"k": torch.ones(2, 3)}], "n": 5}
    assert tdg.buffers_signature(a) == tdg.buffers_signature(b)
    sig = dict((row[0], row[2]) for row in tdg.buffers_signature(a))
    assert sig["params"] == (("module", "Linear",
                              (("weight", (3, 4), "torch.float32"),
                               ("bias", (3,), "torch.float32"))),)
    assert sig["caches"] == (((2, 3), "torch.float32", "cpu"),)
    c = {**a, "params": torch.nn.Linear(4, 5)}
    d = {**a, "caches": [{"k": torch.zeros(2, 3, dtype=torch.bfloat16)}]}
    e = {**a, "caches": [{"k": torch.zeros(2, 3)}, {"k": torch.zeros(2, 3)}]}
    for other in (c, d, e):
        assert tdg.buffers_signature(other) != tdg.buffers_signature(a)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(_imports(f) & {"jax", "jaxlib", "repro"})
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}
