"""The port's pipeline lowering (``repro_torch.core.pipeline``) against the
reference's oracles.

The reference's own sharded run (``repro.core.pipeline.pipeline_apply``
under ``shard_map``) fails with the installed jax (a gather over a
``stage``-sharded operand), so the port is held to what that test holds
it to: JAX's sequential ``tanh`` stack and ``jax.grad`` of it
(``tests/test_distributed.py::test_pipeline_parallel_forward_backward``),
on 4 host positions. Inside the port, the pipeline is bitwise the stack
applied microbatch by microbatch, forward and backward. The wave and
bubble arithmetic equal the reference's and the TDG's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as jpipe  # noqa: E402
from repro_torch.core import pipeline_tdg, topo_waves  # noqa: E402
from repro_torch.core.pipeline import (bubble_fraction, pipeline_apply,  # noqa: E402
                                       pipeline_waves)
from repro_torch.examples import pipeline_demo  # noqa: E402
from repro_torch.launch.mesh import ReplayMesh  # noqa: E402


def _mesh(S: int) -> ReplayMesh:
    return ReplayMesh((S,), ("stage",), ["cpu"] * S)


def _inputs(S, M, mb, d, seed=0):
    rng = np.random.default_rng(seed)
    Ws = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, mb, d)).astype(np.float32)
    return Ws, xs


def _stage(W, x):
    return torch.tanh(x @ W)


def _stack(W, xs):
    """The stack applied microbatch by microbatch."""
    outs = []
    for m in range(xs.shape[0]):
        y = xs[m]
        for s in range(W.shape[0]):
            y = _stage(W[s], y)
        outs.append(y)
    return torch.stack(outs)


def test_reference_case_against_jax_stack_and_grad():
    S, M, mb, d = 4, 8, 2, 16
    Ws, xs = _inputs(S, M, mb, d)
    W = torch.from_numpy(Ws).requires_grad_()
    out = pipeline_apply(_stage, W, torch.from_numpy(xs), _mesh(S))

    def jref(Wj):
        r = jnp.asarray(xs)
        for s in range(S):
            r = jnp.tanh(r @ Wj[s])
        return r

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jref(jnp.asarray(Ws))),
                               atol=1e-5, rtol=1e-5)
    (g,) = torch.autograd.grad((out ** 2).sum(), W)
    g_ref = jax.grad(lambda Wj: (jref(Wj) ** 2).sum())(jnp.asarray(Ws))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_bitwise_the_stack_microbatch_by_microbatch(S, M):
    Ws, xs = _inputs(S, M, 3, 16, seed=S * 10 + M)
    W1 = torch.from_numpy(Ws).requires_grad_()
    W2 = torch.from_numpy(Ws.copy()).requires_grad_()
    x = torch.from_numpy(xs)
    out, ref = pipeline_apply(_stage, W1, x, _mesh(S)), _stack(W2, x)
    assert out.shape == (M, 3, 16)
    assert torch.equal(out, ref)
    (g1,) = torch.autograd.grad((out ** 2).sum(), W1)
    (g2,) = torch.autograd.grad((ref ** 2).sum(), W2)
    assert torch.equal(g1, g2)


def test_pytree_stage_params_and_one_call_a_task():
    S, M = 3, 5
    rng = np.random.default_rng(7)
    params = {"w": torch.from_numpy(rng.standard_normal((S, 8, 8)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((S, 8)).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((M, 2, 8)).astype(np.float32))
    calls = []

    def stage(p, h):
        calls.append(h.shape)
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(stage, params, x, _mesh(S))
    assert len(calls) == S * M
    want = torch.stack([stage({"w": params["w"][2], "b": params["b"][2]},
                              stage({"w": params["w"][1], "b": params["b"][1]},
                                    stage({"w": params["w"][0], "b": params["b"][0]},
                                          x[m])))
                        for m in range(M)])
    assert torch.equal(out, want)


@pytest.mark.parametrize("S,M", [(1, 1), (2, 3), (4, 8), (8, 4), (3, 16)])
def test_waves_and_bubble_equal_the_tdg_and_reference(S, M):
    n = len(topo_waves(pipeline_tdg(S, M, include_backward=False)))
    assert pipeline_waves(S, M) == n == jpipe.pipeline_waves(S, M)
    assert bubble_fraction(S, M) == jpipe.bubble_fraction(S, M)


def test_demo_runs_on_cpu(capsys):
    assert pipeline_demo.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "11 forward waves" in out and "== sequential: OK" in out


def test_demo_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline_demo.main([])
