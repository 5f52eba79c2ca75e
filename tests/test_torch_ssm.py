"""The port's SSM family (mamba2-370m) against the JAX reference.

``reduced(mamba2-370m)`` (d_inner 128, 8 heads of 16, state 16, chunk 16)
in f32, with the JAX parameters carried across by ``params_from_jax``.
The causal conv, ``ssm_apply`` in prefill (the chunked SSD) and in decode
(the single-step recurrence on a carried state), prefill logits and
caches and three decode steps must agree within atol = rtol = 1e-4 (the two
frameworks sum f32 products in different orders), and greedy tokens must be
identical. The decode step must vmap across requests and coalesce in the
``RegionServer`` with no fallback.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import TDG, clear_intern_cache  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving import RegionServer  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402

ARCH = "mamba2-370m"
TOL = 1e-4
MAX_LEN = 24


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(seed, B=2, S=20):
    return np.random.default_rng(seed).integers(2, 256, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _ssm_params(jparams, i):
    return jax.tree_util.tree_map(lambda a: a[i], jparams["layers"])["ssm"]


def _state(rng, cfg):
    dd = ssm.ssm_dims(cfg)
    return {"conv": rng.standard_normal((2, dd["K"] - 1, dd["conv_ch"])).astype(np.float32),
            "ssd": rng.standard_normal((2, dd["heads"], dd["P"], dd["N"])).astype(np.float32)}


def test_full_width_config_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for f in ("family", "num_layers", "d_model", "vocab_size", "padded_vocab", "ssm_state",
              "ssm_headdim", "ssm_expand", "ssm_groups", "ssm_conv", "ssm_chunk",
              "ssm_split_proj", "ssm_inner", "ssm_heads", "tie_embeddings", "dtype",
              "param_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert ssm.ssm_dims(cfg) == JS.ssm_dims(jcfg)
    assert (cfg.ssm_inner, cfg.ssm_heads, cfg.padded_vocab) == (2048, 32, 50432)
    small, jsmall = reduced(cfg), jax_reduced(jcfg)
    assert ssm.ssm_dims(small) == JS.ssm_dims(jsmall)
    assert (small.ssm_chunk, small.ssm_state, small.ssm_headdim) == (16, 16, 16)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(pair, with_state):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(1)
    dd = ssm.ssm_dims(cfg)
    x = rng.standard_normal((2, 7, dd["conv_ch"])).astype(np.float32)
    hist = _state(rng, cfg)["conv"] if with_state else None
    jp = _ssm_params(jparams, 0)["conv"]
    want, want_state = JS._causal_conv(jp["w"], jp["b"], jnp.asarray(x),
                                       None if hist is None else jnp.asarray(hist))
    got, state = ssm._causal_conv(params.layers[0].ssm.conv, torch.from_numpy(x),
                                  None if hist is None else torch.from_numpy(hist))
    _close(got, want, 2e-5)
    _close(state, want_state, 0)


@pytest.mark.parametrize("S", [16, 20, 40])
def test_ssm_apply_prefill_matches(pair, S):
    """The chunked SSD path, from no state and from a carried one (S = 20 is
    not a multiple of the chunk: both sides pad with dt = 0 steps)."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = _state(rng, cfg)
    jp = _ssm_params(jparams, 1)
    want, _ = JS.ssm_apply(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, none = ssm.ssm_apply(params.layers[1].ssm, cfg, torch.from_numpy(x))
    assert none is None
    _close(got, want)
    want, want_st = JS.ssm_apply(jp, jcfg, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()})
    with torch.no_grad():
        got, got_st = ssm.ssm_apply(params.layers[1].ssm, cfg, torch.from_numpy(x),
                                    {k: torch.from_numpy(v) for k, v in st.items()})
    _close(got, want)
    for k in ("conv", "ssd"):
        _close(got_st[k], want_st[k])


def test_ssm_apply_decode_with_state_matches(pair):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    st = _state(rng, cfg)
    want, want_st = JS.ssm_apply(_ssm_params(jparams, 0), jcfg, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()})
    with torch.no_grad():
        got, got_st = ssm.ssm_apply(params.layers[0].ssm, cfg, torch.from_numpy(x),
                                    {k: torch.from_numpy(v) for k, v in st.items()})
    _close(got, want)
    for k in ("conv", "ssd"):
        _close(got_st[k], want_st[k])


def test_prefill_logits_and_caches_match(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(0, S=32)
    jl, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=40)
    with torch.no_grad():
        tl, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=40)
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for jcache, tcache in zip(jc, tc):
        assert set(tcache) == {"ssm"} and set(tcache["ssm"]) == {"conv", "ssd"}
        for key in ("conv", "ssd"):
            _close(tcache["ssm"][key], jcache["ssm"][key])


def test_decode_steps_match(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(1, S=16)
    _, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=24)
    with torch.no_grad():
        _, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=24)
        step_toks = np.random.default_rng(2).integers(2, 256, (3, 2, 1)).astype(np.int32)
        for i in range(3):
            jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(step_toks[i]), jpos, jc)
            tl, tc = M.decode_step(params, cfg, torch.from_numpy(step_toks[i]), tpos, tc)
            _close(tl, jl)
            jpos, tpos = jpos + 1, tpos + 1


def test_greedy_decode_tokens_identical(pair):
    jcfg, jparams, cfg, params = pair
    for seed in (3, 4):
        toks = _tokens(seed, B=3, S=16)
        want = JM.greedy_decode(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 6, 24)
        with torch.no_grad():
            got = M.greedy_decode(params, cfg, {"tokens": torch.from_numpy(toks)}, 6, 24)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_step_is_vmappable_across_requests(pair):
    _, _, cfg, params = pair
    with torch.no_grad():
        states = [M.prefill(params, cfg, {"tokens": torch.from_numpy(_tokens(s))}, 24)
                  for s in (8, 9)]
        toks = torch.tensor([[[5], [6]], [[7], [8]]], dtype=torch.int32)
        pos = torch.stack([s[2] for s in states])
        caches = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs),
                                              *[s[1] for s in states])
        batched, bcaches = torch.func.vmap(
            lambda t, p, c: M.decode_step(params, cfg, t, p, c))(toks, pos, caches)
        for i, (_, c, p) in enumerate(states):
            single, scaches = M.decode_step(params, cfg, toks[i], p, c)
            torch.testing.assert_close(batched[i], single, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(bcaches[0]["ssm"]["ssd"][i], scaches[0]["ssm"]["ssd"],
                                       atol=1e-5, rtol=1e-5)


def test_server_coalesces_ssm_decode(pair):
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
        toks = _tokens(20 + i, S=16)
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


def test_init_params_constants():
    cfg = reduced(get_config(ARCH))
    p = M.init_params(cfg, torch.Generator().manual_seed(0))
    s = p.layers[0].ssm
    assert torch.all(s.A_log == 0) and torch.all(s.D == 1) and torch.all(s.dt_bias == -2)
    assert torch.all(s.conv.b == 0) and torch.all(s.norm.scale == 1)
    assert s.conv.w.abs().max() <= 2 / np.sqrt(cfg.ssm_conv) + 1e-6
    assert s.in_proj.w.shape == (cfg.d_model, ssm.ssm_dims(cfg)["in_dim"])
    assert p.head is None                          # tied embeddings
