"""The port's MoE family (qwen3-moe-30b-a3b) against the JAX reference.

``reduced(qwen3-moe-30b-a3b)`` (4 experts, top-2, expert d_ff 96, qk-norm)
in f32, with the JAX parameters carried across by ``params_from_jax``.
``moe_apply`` (output and aux loss) must agree with and without dropped
tokens, prefill logits and caches and three decode steps within atol =
rtol = 1e-4 (the two frameworks sum f32 products in different orders), and
greedy tokens must be identical. The decode step must vmap across requests
and coalesce in the ``RegionServer`` with no fallback. Expert-parallel
``moe_apply_shard_map`` on CPU (data, model) meshes is held to the
reference's ``moe_apply_gspmd`` at the reference's own tolerance for that
check (atol 2e-4, rtol 2e-3, ``tests/test_distributed.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import TDG, clear_intern_cache  # noqa: E402
from repro_torch.launch.mesh import make_replay_mesh, make_small_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import RegionServer  # noqa: E402
from repro_torch.sharding import partition as P_  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
TOL = 1e-4
MAX_LEN = 24


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(seed, B=2, S=12):
    return np.random.default_rng(seed).integers(2, 256, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _layer(jparams, i, *path):
    node = jax.tree_util.tree_map(lambda a: a[i], jparams["layers"])
    for key in path:
        node = node[key]
    return node


def test_full_width_config_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "d_ff", "vocab_size", "padded_vocab", "qk_norm", "num_experts", "top_k",
              "moe_d_ff", "expert_d_ff", "num_shared_experts", "capacity_factor",
              "router_aux_weight", "moe_impl", "tie_embeddings", "rope_theta", "dtype",
              "param_dtype", "attention", "qkv_bias"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.padded_vocab, cfg.expert_d_ff, jcfg.mlp) == (152064, 768, "swiglu")
    small, jsmall = reduced(cfg), jax_reduced(jcfg)
    for f in ("num_experts", "top_k", "moe_d_ff", "capacity_factor", "qk_norm", "dtype"):
        assert getattr(small, f) == getattr(jsmall, f), f


@pytest.mark.parametrize("n_tokens", [1, 4, 7, 100, 2048])
def test_capacity_matches_reference(n_tokens):
    for arch_cfg in (get_config(ARCH), reduced(get_config(ARCH))):
        jcfg = jax_get_config(ARCH) if arch_cfg.num_layers == 48 else jax_reduced(
            jax_get_config(ARCH))
        assert moe.capacity(arch_cfg, n_tokens) == JMoE.capacity(jcfg, n_tokens)


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0, 0.5])
def test_moe_apply_matches_reference(pair, capacity_factor):
    """Drop-free (4.0) and dropping (1.0, 0.5): the stable-sort drop order,
    the dispatch scatter, the gated combine and the aux loss."""
    jcfg, jparams, cfg, params = pair
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    T, C = 48, moe.capacity(cfg, 48)
    if capacity_factor < 1:
        assert cfg.num_experts * C < T * cfg.top_k           # some tokens must drop
    want, want_aux = JMoE.moe_apply(_layer(jparams, 0, "moe"), jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe.moe_apply(params.layers[0].moe, cfg, torch.from_numpy(x))
    _close(got, want)
    _close(aux, want_aux, 1e-6)


def test_moe_apply_bf16_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16", capacity_factor=1.0)
    cfg = dataclasses.replace(cfg, dtype="bfloat16", capacity_factor=1.0)
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, _ = JMoE.moe_apply(_layer(jparams, 1, "moe"), jcfg,
                             jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, _ = moe.moe_apply(params.layers[1].moe, cfg,
                               torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (2, 1), (1, 4)])
def test_moe_shard_map_matches_reference(pair, mesh_shape):
    """The reference's own check (``test_moe_shard_map_equals_gspmd``):
    x (4, 8, d) through ``moe_impl="shard_map"`` on a (data, model) mesh
    against JAX's ``moe_apply_gspmd`` at atol 2e-4, rtol 2e-3, and, top-2
    without drops (capacity factor 4), bit for bit against the port's own
    unsharded path: each (token, k) lands on one model shard, and the shard
    partials add in shard order. ``aux`` is the mean over the data shards of
    each shard's own loss (the reference's ``pmean``)."""
    jcfg, jparams, cfg, params = pair
    n_data, n_model = mesh_shape
    x = np.random.default_rng(3).standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    jp = _layer(jparams, 0, "moe")
    want, _ = JMoE.moe_apply_gspmd(jp, jcfg, jnp.asarray(x))
    layer, xt = params.layers[0].moe, torch.from_numpy(x)
    sm = dataclasses.replace(cfg, moe_impl="shard_map")
    with torch.no_grad(), P_.use_mesh(make_small_mesh(n_data, n_model, device="cpu")):
        got, aux = moe.moe_apply(layer, sm, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-3)
    with torch.no_grad():
        plain, _ = moe.moe_apply(layer, cfg, xt)
    assert cfg.top_k == 2 and torch.equal(got, plain)
    Bl = 4 // n_data
    want_aux = np.mean([float(JMoE.moe_apply_gspmd(jp, jcfg, jnp.asarray(x[i * Bl:(i + 1) * Bl]))[1])
                        for i in range(n_data)])
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
def test_moe_shard_map_with_drops_matches_per_shard_reference(pair, capacity_factor):
    """With drops, capacity comes from each data shard's own tokens, so the
    expert-parallel layer equals the reference's global dispatch run on
    each data shard alone (same routing, same capacity, same drop order)."""
    jcfg, jparams, cfg, params = pair
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    sm = dataclasses.replace(cfg, capacity_factor=capacity_factor, moe_impl="shard_map")
    x = np.random.default_rng(4).standard_normal((4, 12, cfg.d_model)).astype(np.float32)
    jp = _layer(jparams, 1, "moe")
    want = np.concatenate([np.asarray(JMoE.moe_apply_gspmd(jp, jcfg, jnp.asarray(x[i:i + 2]))[0])
                           for i in (0, 2)])
    with torch.no_grad(), P_.use_mesh(make_small_mesh(2, 2, device="cpu")):
        got, _ = moe.moe_apply(params.layers[1].moe, sm, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-3)


def test_shard_map_needs_a_model_axis(pair):
    """Without an active mesh holding "model", ``moe_impl="shard_map"``
    takes the global dispatch, as the reference's ``moe_apply`` does."""
    _, _, cfg, params = pair
    sm = dataclasses.replace(cfg, moe_impl="shard_map")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, _ = moe.moe_apply_gspmd(params.layers[0].moe, cfg, x)
        with P_.use_mesh(make_replay_mesh(2, device="cpu")):
            got, _ = moe.moe_apply(params.layers[0].moe, sm, x)
    assert torch.equal(got, want)


def test_router_keeps_top_k_order(pair):
    """``topk`` gives the K choices in ``lax.top_k``'s descending order,
    which the capacity ranks (and so the drop order) depend on."""
    jcfg, jparams, cfg, params = pair
    x = np.random.default_rng(3).standard_normal((30, cfg.d_model)).astype(np.float32)
    jw = _layer(jparams, 0, "moe", "router", "w")
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jw, axis=-1)
    _, jidx = jax.lax.top_k(jprobs, cfg.top_k)
    probs, gates, idx = moe.route(params.layers[0].moe, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(probs, jprobs, 2e-6)
    torch.testing.assert_close(gates.sum(-1), torch.ones(30))


def test_qk_norm_attention_matches(pair):
    jcfg, jparams, cfg, params = pair
    assert params.layers[0].attn.qnorm is not None
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want, _ = JL.attention_apply(_layer(jparams, 0, "attn"), jcfg, jnp.asarray(x),
                                 jnp.asarray(pos))
    with torch.no_grad():
        got, _ = L.attention_apply(params.layers[0].attn, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    _close(got, want, 2e-5)


def test_prefill_logits_caches_and_aux_match(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(0)
    jl, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=16)
    _, jaux, _ = JM.hidden_states(jparams, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=16)
        _, aux, _ = M.hidden_states(params, cfg, torch.from_numpy(toks))
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl)
    _close(aux, jaux, 1e-6)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for jcache, tcache in zip(jc, tc):
        for key in ("k", "v"):             # keys are cached after knorm and RoPE
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
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_step_is_vmappable_across_requests(pair):
    """What the server's coalescing relies on: the whole dispatch (sort,
    scatter counts, index_put, index_add) batches under vmap."""
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


def test_server_coalesces_moe_decode(pair):
    """Three tenants' decode steps in one coalesced replay: no fallback, and
    each tenant's next token equals JAX's greedy step."""
    jcfg, jparams, cfg, params = pair
    clear_intern_cache()
    decode = make_serve_step(cfg)
    server = RegionServer(max_batch=4, max_wait_ms=0, autostart=False)
    for i in range(3):
        g = TDG(f"decode[{i}]")
        g.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                   outs=["next", "caches"], name="decode")
        server.register_tenant(f"t{i}", g, outputs=("next", "caches"))
    futures, wants = [], []
    for i in range(3):
        toks = _tokens(20 + i, S=10)
        jl, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, MAX_LEN)
        jtok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
        jnext, _ = JM.decode_step(jparams, jcfg, jtok[:, None], jpos, jc)
        wants.append(np.asarray(jnp.argmax(jnext[:, -1], axis=-1)))
        with torch.no_grad():
            tl, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
        tok = torch.argmax(tl[:, -1], dim=-1).to(torch.int32)
        futures.append(server.submit(f"t{i}", {"params": params, "tokens": tok[:, None],
                                               "pos": tpos, "caches": tc}))
    server.start()
    outs = [f.result(timeout=120) for f in futures]
    server.close()
    for out, want in zip(outs, wants):
        np.testing.assert_array_equal(out["next"].numpy(), want)
    m = server.stats()["metrics"]
    assert m["batch_fallbacks"] == 0 and m["batch_occupancy_max"] == 3
    assert m["completed"] == 3


def test_init_params_is_seeded_and_shaped():
    cfg = reduced(get_config(ARCH))
    a = M.init_params(cfg, torch.Generator().manual_seed(0))
    b = M.init_params(cfg, torch.Generator().manual_seed(0))
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0)
    ex = a.layers[0].moe.experts
    E, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    assert (ex.up.w.shape, ex.gate.w.shape, ex.down.w.shape) == ((E, d, f), (E, d, f), (E, f, d))
    assert ex.up.w.abs().max() <= 2 / np.sqrt(d) + 1e-6 and ex.up.w.std() > 0.3 / np.sqrt(d)
    assert ex.down.w.abs().max() <= 2 / np.sqrt(f) + 1e-6
    assert a.layers[0].moe.router.w.shape == (d, E)
    assert torch.all(a.layers[0].attn.qnorm.scale == 1)
    assert a.head is not None and a.head.table.shape == (cfg.padded_vocab, d)
