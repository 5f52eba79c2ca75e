"""The port's hybrid family (hymba-1.5b: attention ∥ SSM in each block,
fused as the mean of the two outputs' RMSNorms) and the split-projection
SSM layout (``ssm_split_proj``) against the JAX reference.

Each variant at ``reduced()`` in f32 (hymba: sliding window 32, SSM heads
of 16, state 16, chunk 16), with the JAX parameters carried across by
``params_from_jax``: the config field by field, prefill logits and caches
(the attention ring and the SSM's conv and SSD states), three decode
steps, greedy tokens (identical), ``loss_fn``'s loss and gradients against
``jax.value_and_grad``, the decode step under ``torch.func.vmap`` and in a
coalesced ``RegionServer`` step; at atol = rtol = 1e-4 (the two frameworks
sum f32 products in different orders). Prompts of 40 tokens pass the
32-token window. The split layout runs in hymba's blocks and in a mamba2
stack; its conv state (the x, B and C histories side by side) is held to
the reference's directly.
"""
import dataclasses

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
from repro_torch.configs.base import PORT_FIELDS  # noqa: E402
from repro_torch.core import TDG, clear_intern_cache  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving import RegionServer  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402

ARCH = "hymba-1.5b"
VARIANTS = [("hymba-1.5b", False), ("hymba-1.5b", True), ("mamba2-370m", True)]
IDS = ["hymba", "hymba-split", "mamba2-split"]
TOL = 1e-4
MAX_LEN = 48
_PAIRS: dict = {}


def _pair(arch, split):
    """(JAX config, JAX params, port config, port model): the same weights."""
    if (arch, split) not in _PAIRS:
        jcfg = jax_reduced(jax_get_config(arch), ssm_split_proj=split)
        cfg = reduced(get_config(arch), ssm_split_proj=split)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        model = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
        _PAIRS[arch, split] = (jcfg, jparams, cfg, model)
    return _PAIRS[arch, split]


def _tokens(seed, B=2, S=40):
    return np.random.default_rng(seed).integers(2, 256, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_caches(tc, jc):
    for tcache, jcache in zip(tc, jc, strict=True):
        assert set(tcache) == set(jcache)
        for part, leaves in tcache.items():
            assert set(leaves) == set(jcache[part])
            for k, leaf in leaves.items():
                if k == "pos":
                    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jcache[part][k]))
                else:
                    _close(leaf, jcache[part][k])


def test_config_matches_reference():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH)))):
        for f in dataclasses.fields(cfg):
            if f.name in PORT_FIELDS:   # the port's own, at their defaults here
                assert getattr(cfg, f.name) == f.default, f.name
            else:
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert ssm.ssm_dims(cfg) == JS.ssm_dims(jcfg)
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.hybrid_ssm, cfg.ssm_inner, cfg.ssm_heads) == ("hybrid", True,
                                                                           3200, 50)


@pytest.mark.parametrize("arch,split", VARIANTS, ids=IDS)
def test_prefill_logits_and_caches_match(arch, split):
    jcfg, jparams, cfg, params = _pair(arch, split)
    toks = _tokens(0)
    jl, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                 max_len=MAX_LEN)
    _close(tl, jl)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert "ssm" in tc[0] and ("attn" in tc[0]) == (arch == ARCH)
    _close_caches(tc, jc)


@pytest.mark.parametrize("arch,split", VARIANTS, ids=IDS)
def test_decode_steps_match(arch, split):
    jcfg, jparams, cfg, params = _pair(arch, split)
    toks = _tokens(1)
    _, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    with torch.no_grad():
        _, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                max_len=MAX_LEN)
        step_toks = np.random.default_rng(2).integers(2, 256, (3, 2, 1)).astype(np.int32)
        for i in range(3):
            jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(step_toks[i]), jpos, jc)
            tl, tc = M.decode_step(params, cfg, torch.from_numpy(step_toks[i]), tpos, tc)
            _close(tl, jl)
            jpos, tpos = jpos + 1, tpos + 1
    _close_caches(tc, jc)


@pytest.mark.parametrize("arch,split", VARIANTS, ids=IDS)
def test_greedy_decode_tokens_identical(arch, split):
    jcfg, jparams, cfg, params = _pair(arch, split)
    toks = _tokens(3, B=3)
    want = JM.greedy_decode(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 6, MAX_LEN)
    with torch.no_grad():
        got = M.greedy_decode(params, cfg, {"tokens": torch.from_numpy(toks)}, 6, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,split", VARIANTS, ids=IDS)
def test_loss_and_gradients_match(arch, split):
    jcfg, jparams, cfg, model = _pair(arch, split)
    toks = _tokens(4, S=32)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}), has_aux=True)(jparams)
    diff = {k: v.clone().requires_grad_() for k, v in M.params_of(model).items()}
    loss, m = M.loss_fn(M.bind(cfg, diff), cfg, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, list(diff.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=TOL, rtol=TOL)
    want = M.flatten_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want) == set(diff)
    for k, g in zip(diff, grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("arch,split", VARIANTS, ids=IDS)
def test_decode_step_is_vmappable_across_requests(arch, split):
    """The SSM state (and hymba's attention ring) carried through a vmapped step."""
    _, _, cfg, params = _pair(arch, split)
    with torch.no_grad():
        states = [M.prefill(params, cfg, {"tokens": torch.from_numpy(_tokens(s))}, MAX_LEN)
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
            for k in ("conv", "ssd"):
                torch.testing.assert_close(bcaches[1]["ssm"][k][i], scaches[1]["ssm"][k],
                                           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,with_state", [(20, False), (20, True), (1, True)])
def test_split_projection_conv_state_matches(S, with_state):
    """The split layout's conv state is the x, B and C histories side by
    side (in that order), as the fused layout's one conv over xBC keeps it."""
    jcfg, jparams, cfg, params = _pair(ARCH, True)
    rng = np.random.default_rng(10 + S)
    dd = ssm.ssm_dims(cfg)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.standard_normal((2, dd["K"] - 1, dd["conv_ch"])).astype(np.float32),
          "ssd": rng.standard_normal((2, dd["heads"], dd["P"], dd["N"])).astype(np.float32)}
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])["ssm"]
    jst = {k: jnp.asarray(v) for k, v in st.items()} if with_state else None
    want, want_st = JS.ssm_apply(jp, jcfg, jnp.asarray(x), jst)
    with torch.no_grad():
        got, got_st = ssm.ssm_apply(params.layers[0].ssm, cfg, torch.from_numpy(x),
                                    {k: torch.from_numpy(v) for k, v in st.items()}
                                    if with_state else None)
    _close(got, want)
    assert (got_st is None) == (not with_state)
    if with_state:
        assert got_st["conv"].shape == (2, dd["K"] - 1, dd["conv_ch"])
        _close(got_st["conv"], want_st["conv"])
        _close(got_st["ssd"], want_st["ssd"])
    names = {n.split(".")[0] for n, _ in params.layers[0].ssm.named_parameters()}
    assert {"z_proj", "x_proj", "b_proj", "c_proj", "dt_proj", "xconv", "bconv",
            "cconv"} <= names and "in_proj" not in names


def test_forward_and_param_count_match():
    jcfg, jparams, cfg, params = _pair(ARCH, False)
    toks = _tokens(5, S=12)
    jl, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, _ = M.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    _close(logits, jl)
    assert M.param_count(params) == JM.param_count(jparams)


def test_server_coalesces_hybrid_decode():
    """Three tenants' decode steps in one coalesced replay: no fallback, and
    each tenant's next token equals JAX's greedy step."""
    jcfg, jparams, cfg, params = _pair(ARCH, False)
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
        toks = _tokens(20 + i)
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


def test_serve_cli_runs_hymba_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--smoke", "--server", "--device", "cpu", "--gen", "3",
                       "--prompt-len", "40", "--batch", "2", "--tenants", "2"]) == 0
    out = capsys.readouterr().out
    assert "0 fallbacks" in out and "ssd_intra_chunk 0" in out
