"""The port's dense decoder against the JAX reference.

``reduced(qwen2.5-3b)`` in f32, with the JAX parameters carried across by
``params_from_jax`` (JAX's own init hashes salted strings, so weights are
never re-initialized for parity). Prefill logits and caches, then three
decode steps, must agree within atol = rtol = 1e-4 (the two frameworks
sum f32 products in different orders); greedy tokens must be identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"))
    cfg = reduced(get_config("qwen2.5-3b"))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(seed, B=2, S=12):
    return np.random.default_rng(seed).integers(2, 256, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_full_width_config_matches_reference():
    jcfg, cfg = jax_get_config("qwen2.5-3b"), get_config("qwen2.5-3b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "d_ff", "vocab_size", "padded_vocab", "qkv_bias", "tie_embeddings",
              "rope_theta", "dtype", "param_dtype", "attention"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.padded_vocab == 152064
    assert (jcfg.mlp, jcfg.qk_norm) == ("swiglu", False)   # what the port implements
    assert cfg.compute_dtype == torch.bfloat16
    assert cfg.param_torch_dtype == torch.float32
    small = reduced(cfg)
    assert (small.num_layers, small.d_model, small.head_dim, small.dtype) == (2, 64, 16, "float32")


def test_prefill_logits_and_caches_match(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(0)
    jl, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=16)
    with torch.no_grad():
        tl, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=16)
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for jcache, tcache in zip(jc, tc):
        for key in ("k", "v"):
            _close(tcache["attn"][key], jcache["attn"][key])
        np.testing.assert_array_equal(tcache["attn"]["pos"].numpy(),
                                      np.asarray(jcache["attn"]["pos"]))


def test_decode_steps_match(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(1)
    _, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=16)
    with torch.no_grad():
        _, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=16)
        step_toks = np.random.default_rng(2).integers(2, 256, (3, 2, 1)).astype(np.int32)
        for i in range(3):
            jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(step_toks[i]), jpos, jc)
            tl, tc = M.decode_step(params, cfg, torch.from_numpy(step_toks[i]), tpos, tc)
            _close(tl, jl)
            jpos, tpos = jpos + 1, tpos + 1


def test_greedy_decode_tokens_identical(pair):
    jcfg, jparams, cfg, params = pair
    for seed in (3, 4):
        toks = _tokens(seed, B=3, S=10)
        want = JM.greedy_decode(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 6, 16)
        with torch.no_grad():
            got = M.greedy_decode(params, cfg, {"tokens": torch.from_numpy(toks)}, 6, 16)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e6), (0.5, 1e4), (1.0, 0.0)])
def test_apply_rope_matches(fraction, theta):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta, fraction=fraction)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta,
                       fraction=fraction)
    _close(got, want, 2e-5)


def test_linear_bias_order_matches(pair):
    _, jparams, cfg, params = pair
    x = np.random.default_rng(6).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])["attn"]["wq"]
    want = JL.linear(jp, jnp.asarray(x), jnp.float32)
    _close(L.linear(params.layers[0].attn.wq, torch.from_numpy(x), torch.float32), want, 2e-5)


def test_cached_attention_ring_buffer_matches(pair):
    """Sliding-window layer: the ring cache wraps, masks use slot positions."""
    jcfg, _, cfg, _ = pair
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "attention": "sliding", "window": 4})
    cfg = cfg.__class__(**{**cfg.__dict__, "attention": "sliding", "window": 4})
    rng = np.random.default_rng(7)
    jcache = JL.init_attn_cache(jcfg, 0, 2, 16)
    tcache = L.init_attn_cache(cfg, 0, 2, 16)
    assert tcache["k"].shape == (2, 4, cfg.num_kv_heads, cfg.head_dim)
    for step in range(6):
        q = rng.standard_normal((2, 1, cfg.num_heads, cfg.head_dim)).astype(np.float32)
        kv = rng.standard_normal((2, 2, 1, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
        pos = np.full((2, 1), step, np.int32)
        jo, jcache = JL._cached_attention(jcfg, jnp.asarray(q), jnp.asarray(kv[0]),
                                          jnp.asarray(kv[1]), jnp.asarray(pos), jcache,
                                          pattern="sliding", span=4)
        to, tcache = L._cached_attention(cfg, torch.from_numpy(q), torch.from_numpy(kv[0]),
                                         torch.from_numpy(kv[1]), torch.from_numpy(pos),
                                         tcache, pattern="sliding", span=4)
        _close(to, jo, 2e-5)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_decode_step_is_vmappable_across_requests(pair):
    """What the server's coalescing relies on: vmapped decode == per-request."""
    _, _, cfg, params = pair
    with torch.no_grad():
        states = [M.prefill(params, cfg, {"tokens": torch.from_numpy(_tokens(s))}, 16)
                  for s in (8, 9)]
        toks = torch.tensor([[[5], [6]], [[7], [8]]], dtype=torch.int32)
        pos = torch.stack([s[2] for s in states])
        caches = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs),
                                              *[s[1] for s in states])
        batched, _ = torch.func.vmap(
            lambda t, p, c: M.decode_step(params, cfg, t, p, c))(toks, pos, caches)
        for i, (_, c, p) in enumerate(states):
            single, _ = M.decode_step(params, cfg, toks[i], p, c)
            torch.testing.assert_close(batched[i], single, atol=1e-5, rtol=1e-5)


def test_init_params_is_seeded_and_shaped():
    cfg = reduced(get_config("qwen2.5-3b"))
    a = M.init_params(cfg, torch.Generator().manual_seed(0))
    b = M.init_params(cfg, torch.Generator().manual_seed(0))
    c = M.init_params(cfg, torch.Generator().manual_seed(1))
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0)
        assert not pa.requires_grad
        if n.endswith(".w") or n.endswith("table"):
            assert not torch.equal(pa, pc), n
            std = 1.0 / np.sqrt(pa.shape[0] if n.endswith(".w") else pa.shape[1])
            assert pa.abs().max() <= 2 * std + 1e-6, n
    assert a.head is None                       # tied embeddings
    assert torch.all(a.final_norm.scale == 1)
    assert torch.all(a.layers[0].attn.wq.b == 0)
    assert a.embed.table.shape == (cfg.padded_vocab, cfg.d_model)


def test_params_from_jax_rejects_mismatched_shapes(pair):
    jcfg, jparams, cfg, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["final_norm"]["scale"] = np.ones(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="final_norm.scale"):
        M.params_from_jax(tree, cfg, "cpu")
