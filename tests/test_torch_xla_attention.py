"""The port's memory-bounded plain attention against ``repro.kernels.xla_attention``.

The same numpy inputs go through each ``sdpa_*`` of both packages (grouped
GQA, query chunks, the banded sliding window, block-diagonal chunks, cross
attention, and the small/ragged fallbacks), at the repo's tolerances (f32
2e-5, bf16 2e-2). ``ops.attention``'s ``ref`` substrate routes through them
as the reference's does; where the reference's routing drops a mask or an
offset, the port takes the oracle (``ref.attention_ref``) instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import xla_attention as jxla  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import xla_attention as xla  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, B, Sq, Sk, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, hq, d), (B, Sk, hkv, d), (B, Sk, hkv, d))]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn,S,kw", [
    ("sdpa_full", 64, {"chunk": 16}),            # four query chunks
    ("sdpa_full", 50, {"chunk": 16}),            # ragged: one pass
    ("sdpa_full", 64, {"chunk": 16, "causal": False}),
    ("sdpa_full", 32, {"q_offset": 5}),
    ("sdpa_sliding", 64, {"window": 16}),        # banded
    ("sdpa_sliding", 40, {"window": 16}),        # ragged: masked small
    ("sdpa_chunked", 64, {"chunk": 16}),         # block-diagonal
    ("sdpa_chunked", 12, {"chunk": 16}),         # shorter than a chunk
    ("sdpa_cross", 48, {})])
def test_sdpa_matches_reference(fn, S, kw, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(0, 2, S, S, 8, 2, 32, dtype)
    got = getattr(xla, fn)(q, k, v, **kw)
    want = getattr(jxla, fn)(jq, jk, jv, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)


def test_cross_attention_with_other_key_length():
    (q, k, v), (jq, jk, jv) = _qkv(1, 2, 24, 56, 4, 1, 16, "float32")
    _close(xla.sdpa_cross(q, k, v), jxla.sdpa_cross(jq, jk, jv), "float32")


def test_bounded_scores_never_materialize_all_queries():
    """sdpa_full scores one query chunk at a time: no (B, H, Sq, Sk) tensor."""
    (q, k, v), _ = _qkv(2, 1, 64, 64, 4, 4, 16, "float32")
    seen = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.einsum:
                seen.append(tuple(out.shape))
            return out

    with Spy():
        xla.sdpa_full(q, k, v, chunk=16)
    assert len(seen) == 8          # scores and output, for each of 4 chunks
    assert max(int(np.prod(s)) for s in seen) == 4 * 16 * 64   # one chunk's scores


@pytest.mark.parametrize("kw", [{}, {"causal": False}, {"window": 16}, {"chunk": 16},
                                {"q_chunk": 16}])
def test_ops_ref_routes_as_reference(kw):
    (q, k, v), (jq, jk, jv) = _qkv(3, 2, 64, 64, 8, 2, 32, "float32")
    got = ops.attention(q, k, v, **kw)
    with jops.registry.kernel_mode_scope("ref"):
        want = jops.attention(jq, jk, jv, **kw)
    _close(got, want, "float32")
    _close(got, ref.attention_ref(q, k, v, **{k_: v_ for k_, v_ in kw.items()
                                              if k_ != "q_chunk"}), "float32")


@pytest.mark.parametrize("kw", [{"window": 16, "q_offset": 8},
                                {"chunk": 16, "causal": False},
                                {"window": 16, "causal": False}])
def test_ops_ref_keeps_what_the_reference_routing_drops(kw):
    """The reference's ``_attention_ref`` ignores ``q_offset`` with a window
    or chunk and ignores both masks without causality; the port applies
    them all, as the flash-attention kernel and the oracle do."""
    (q, k, v), (jq, jk, jv) = _qkv(4, 1, 32, 32, 4, 2, 16, "float32")
    got = ops.attention(q, k, v, **kw)
    _close(got, ref.attention_ref(q, k, v, **kw), "float32")
    with jops.registry.kernel_mode_scope("ref"):
        dropped = np.asarray(jops.attention(jq, jk, jv, **kw))
    assert np.abs(got.numpy() - dropped).max() > 1e-3
