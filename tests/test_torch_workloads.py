"""The port's paper workloads and quickstart against ``benchmarks/workloads.py``.

Each workload is built by both packages at a small size. The TDGs must be
equal (edges and record-time dependency lookups). The port's buffers go, as
numpy arrays, through the reference's TDG (its payloads, replayed by
``repro.core.ReplayExecutor``), and the port's captured-path replay, its
uncaptured fused replay and its eager run must match that output at the
workload's own verify tolerance (Heat and N-body have none in the
reference: the repo's f32 tolerance, 2e-5), and pass the port's ``verify``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from benchmarks import workloads as jw  # noqa: E402
from repro_torch import workloads as tw  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402

# name: (sizes, (atol, rtol) of the reference's verify, or the repo's f32 2e-5)
CASES = {
    "cholesky": ({"n": 256, "nb": 4}, (1e-6 * 256, 1e-7)),
    "heat": ({"n": 64, "nb": 4, "iters": 2}, (2e-5, 2e-5)),
    "nbody": ({"n_particles": 256, "nb": 4}, (2e-5, 2e-5)),
    "axpy": ({"n": 1 << 12, "nb": 8}, (1e-6, 1e-5)),
    "dotp": ({"n": 1 << 12, "nb": 8}, (0.0, 1e-3)),
    "rmsnorm": ({"n_tokens": 256, "d": 128, "nb": 4, "depth": 2}, (1e-4, 1e-4)),
    "attention": ({"n_seqs": 8, "seq": 64, "heads": 4, "head_dim": 32, "nb": 4},
                  (2e-3, 2e-3)),
}


@pytest.fixture(autouse=True)
def _fresh():
    T.reset_registry()
    T.clear_intern_cache()
    yield
    T.reset_registry()
    T.clear_intern_cache()


def _edges(tdg):
    return sorted((e.src, e.dst, e.kind.value, e.slot) for e in tdg.edges)


def _rebind(fn, name, value):
    """Point the closure variable ``name`` of ``fn`` at ``value``."""
    fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents = value


def _close(got, want, atol, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(want[k], dtype=np.float64),
                                   atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_workload_matches_reference(name):
    sizes, (atol, rtol) = CASES[name]
    tdg, bufs, verify = tw.WORKLOADS[name](**sizes, device="cpu")
    jtdg, _, _ = jw.WORKLOADS[name](**sizes)
    assert tdg.region == jtdg.region
    assert _edges(tdg) == _edges(jtdg)
    assert tdg.dep_lookups() == jtdg.dep_lookups()
    assert all(v.dtype == torch.float32 for v in bufs.values())

    if name == "nbody":   # the reference's payload closes over its own positions
        _rebind(jtdg.tasks[0].fn, "allpos", jnp.asarray(
            torch.cat([bufs[f"P{b}"] for b in range(sizes["nb"])]).numpy()))
    want = J.ReplayExecutor(jtdg).run({k: jnp.asarray(v.numpy()) for k, v in bufs.items()})
    replay = T.ReplayExecutor(tdg).run(dict(bufs))
    uncaptured = T.lower_tdg(tdg, jit=False)
    fused = uncaptured(dict(bufs))
    eager = T.EagerExecutor(tdg, n_workers=4).run(dict(bufs))
    for out in (replay, fused, eager):
        verify(out)
        _close({k: v.numpy() for k, v in out.items()}, want, atol, rtol)
    plan = uncaptured.last_plan
    assert plan.fused_classes >= 1
    assert not any("fallback" in c.reason for c in plan.classes)


@pytest.mark.parametrize("name", ["rmsnorm", "attention"])
def test_kernel_workloads_fuse_with_vmap(name):
    """The kernel workloads' waves fuse through the ops' vmap rules (here
    the plain versions; on the card, the custom ops') with no fallback."""
    tdg, bufs, _ = tw.WORKLOADS[name](**CASES[name][0], device="cpu")
    f = T.lower_tdg(tdg, jit=False)
    f(dict(bufs))
    assert all(c.fused and c.batcher == "vmap" for c in f.last_plan.classes)


@pytest.mark.parametrize("name", ["rmsnorm", "attention"])
def test_bf16_workloads_match_reference(name):
    sizes = dict(CASES[name][0], dtype=torch.bfloat16)
    tdg, bufs, verify = tw.WORKLOADS[name](**sizes, device="cpu")
    assert bufs["x0" if name == "rmsnorm" else "q0"].dtype == torch.bfloat16
    jtdg, _, _ = jw.WORKLOADS[name](**CASES[name][0])
    out = T.ReplayExecutor(tdg).run(dict(bufs))
    verify(out)
    jbufs = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.float32 if v.dtype == torch.float32 else jnp.bfloat16) for k, v in bufs.items()}
    want = J.ReplayExecutor(jtdg).run(jbufs)
    _close({k: v.float().numpy() for k, v in out.items()},
            {k: np.asarray(v, dtype=np.float32) for k, v in want.items()}, 2e-2, 2e-2)


def test_region_records_and_replays_a_workload():
    tdg, bufs, verify = tw.cholesky(n=128, nb=4, device="cpu")
    region = tw.as_region(tdg)
    rec = region(**bufs)
    rep = region(**bufs)
    assert (region.records, region.replays) == (1, 1)
    assert _edges(region.tdg) == _edges(tdg)
    verify(rec)
    verify(rep)
    assert region.schedule_summary()["tasks"] == tdg.num_tasks


def test_attention_blocks_needs_whole_blocks():
    with pytest.raises(ValueError, match="multiple"):
        tw.attention_blocks(n_seqs=6, nb=4, device="cpu")


def test_quickstart_verifies_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu", "--n", "64", "--nb", "4", "--reps", "1"])
    out = capsys.readouterr().out
    assert "verified against np.linalg.cholesky — OK" in out
    assert "20 tasks" in out


def test_quickstart_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        quickstart.main(["--n", "64", "--nb", "4"])
