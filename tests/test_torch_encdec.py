"""The port's encoder-decoder family (whisper-small: a bidirectional
encoder over stub frame embeddings, LayerNorm blocks, sinusoidal positions,
decoder blocks with cross-attention) against the JAX reference.

``reduced(whisper-small)`` in f32 (2 encoder + 2 decoder layers, 24
frames), with the JAX parameters carried across by ``params_from_jax``
(the encoder's stacked layers and every LayerNorm bias included): the
config field by field, the encoder's output, prefill logits and caches
(the cross-attention's K/V of the encoder output among them), three decode
steps (cross-attention from the cache), greedy tokens (identical),
``loss_fn``'s loss and gradients against ``jax.value_and_grad``, the
decode step under ``torch.func.vmap`` and in a coalesced ``RegionServer``
step; at atol = rtol = 1e-4 (the two frameworks sum f32 products in
different orders). Also LayerNorm, both sinusoids, cross-attention with
Sq != Sk, and the serve and train launchers on the CPU.
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
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import PORT_FIELDS  # noqa: E402
from repro_torch.core import TDG, clear_intern_cache  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import RegionServer  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402

ARCH = "whisper-small"
TOL = 1e-4
MAX_LEN = 24


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, model


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(2, 256, (B, S)).astype(np.int32),
            "frames": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_caches(tc, jc):
    for tcache, jcache in zip(tc, jc, strict=True):
        assert set(tcache) == set(jcache) == {"attn", "cross_kv"}
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
    small = reduced(get_config(ARCH))
    assert (small.encoder_layers, small.encoder_seq, small.mlp) == (2, 24, "gelu")
    assert reduced(get_config("qwen2.5-3b")).encoder_layers == 0


def test_encoder_output_matches(pair):
    jcfg, jparams, cfg, params = pair
    frames = _batch(cfg, 0)["frames"]
    want = JM._encode(jparams, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = M.encode(params, cfg, torch.from_numpy(frames))
    _close(got, want)


def test_prefill_logits_and_caches_match(pair):
    jcfg, jparams, cfg, params = pair
    batch = _batch(cfg, 1)
    jl, jc, jpos = JM.prefill(jparams, jcfg, _jax(batch), max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc, tpos = M.prefill(params, cfg, _torch(batch), max_len=MAX_LEN)
    assert tc[0]["cross_kv"]["k"].shape == (2, cfg.encoder_seq, cfg.num_kv_heads,
                                            cfg.head_dim)
    _close(tl, jl)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _close_caches(tc, jc)


def test_decode_steps_match(pair):
    jcfg, jparams, cfg, params = pair
    batch = _batch(cfg, 2)
    _, jc, jpos = JM.prefill(jparams, jcfg, _jax(batch), max_len=MAX_LEN)
    with torch.no_grad():
        _, tc, tpos = M.prefill(params, cfg, _torch(batch), max_len=MAX_LEN)
        step_toks = np.random.default_rng(3).integers(2, 256, (3, 2, 1)).astype(np.int32)
        for i in range(3):
            jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(step_toks[i]), jpos, jc)
            tl, tc = M.decode_step(params, cfg, torch.from_numpy(step_toks[i]), tpos, tc)
            _close(tl, jl)
            jpos, tpos = jpos + 1, tpos + 1
    _close_caches(tc, jc)


@pytest.mark.parametrize("seed", [4, 5])
def test_greedy_decode_tokens_identical(pair, seed):
    jcfg, jparams, cfg, params = pair
    batch = _batch(cfg, seed, B=3)
    want = JM.greedy_decode(jparams, jcfg, _jax(batch), 6, MAX_LEN)
    with torch.no_grad():
        got = M.greedy_decode(params, cfg, _torch(batch), 6, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_loss_and_gradients_match(pair):
    """The encoder's and the cross-attention's weights get their gradients
    through the encoder output."""
    jcfg, jparams, cfg, model = pair
    batch = _batch(cfg, 6)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, _jax(batch)), has_aux=True)(jparams)
    diff = {k: v.clone().requires_grad_() for k, v in M.params_of(model).items()}
    loss, m = M.loss_fn(M.bind(cfg, diff), cfg, _torch(batch))
    grads = torch.autograd.grad(loss, list(diff.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=TOL, rtol=TOL)
    want = M.flatten_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want) == set(diff)
    assert {"encoder.1.mlp.up.w", "enc_norm.bias", "layers.0.cross.wk.w"} <= set(want)
    for k, g in zip(diff, grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=TOL, rtol=TOL, err_msg=k)


def test_forward_and_param_count_match(pair):
    jcfg, jparams, cfg, params = pair
    batch = _batch(cfg, 7)
    jl, _ = JM.forward(jparams, jcfg, _jax(batch))
    with torch.no_grad():
        logits, _ = M.forward(params, cfg, _torch(batch))
    _close(logits, jl)
    assert M.param_count(params) == JM.param_count(jparams)


def test_decode_step_is_vmappable_across_requests(pair):
    """The cross-attention's cached K/V carried through a vmapped step."""
    _, _, cfg, params = pair
    with torch.no_grad():
        states = [M.prefill(params, cfg, _torch(_batch(cfg, s)), MAX_LEN) for s in (8, 9)]
        toks = torch.tensor([[[5], [6]], [[7], [8]]], dtype=torch.int32)
        pos = torch.stack([s[2] for s in states])
        caches = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs),
                                              *[s[1] for s in states])
        batched, bcaches = torch.func.vmap(
            lambda t, p, c: M.decode_step(params, cfg, t, p, c))(toks, pos, caches)
        for i, (_, c, p) in enumerate(states):
            single, scaches = M.decode_step(params, cfg, toks[i], p, c)
            torch.testing.assert_close(batched[i], single, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(bcaches[1]["cross_kv"]["v"][i],
                                       scaches[1]["cross_kv"]["v"], atol=0, rtol=0)


def test_layernorm_matches():
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((3, 5, 64)) * 4 + 1).astype(np.float32)
    jp = {"scale": jnp.asarray(rng.standard_normal(64).astype(np.float32)),
          "bias": jnp.asarray(rng.standard_normal(64).astype(np.float32))}
    p = L.LayerNorm(64)
    p.scale.copy_(torch.from_numpy(np.array(jp["scale"])))
    p.bias.copy_(torch.from_numpy(np.array(jp["bias"])))
    _close(L.layernorm(p, torch.from_numpy(x)), JL.layernorm(jp, jnp.asarray(x)), 2e-5)
    got = L.layernorm(p, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16


def test_sinusoidal_positions_match():
    _close(L.sinusoidal_positions(1500, 768), JL.sinusoidal_positions(1500, 768))


def test_sinusoid_at_decode_positions_matches():
    pos = np.array([[0, 7], [511, 1023]], np.int32)
    want = JM._sinusoidal_at(jnp.asarray(pos), 64)
    _close(L.sinusoidal_at(torch.from_numpy(pos), 64), want, 2e-5)


def test_cross_attention_matches(pair):
    """Sq != Sk, non-causal, no RoPE, key positions 0 (prefill's form)."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"])["cross"]
    want, _ = JL.attention_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), causal=False,
                                 kv_x=jnp.asarray(enc),
                                 kv_positions=jnp.zeros((2, cfg.encoder_seq), jnp.int32),
                                 use_rope=False)
    with torch.no_grad():
        got, _ = L.attention_apply(params.layers[1].cross, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()),
                                   kv_x=torch.from_numpy(enc), use_rope=False)
    _close(got, want)
    assert params.layers[1].cross.qnorm is None


def test_server_coalesces_encdec_decode(pair):
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
        batch = _batch(cfg, 20 + i)
        jl, jc, jpos = JM.prefill(jparams, jcfg, _jax(batch), MAX_LEN)
        jtok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
        jnext, _ = JM.decode_step(jparams, jcfg, jtok[:, None], jpos, jc)
        wants.append(np.asarray(jnp.argmax(jnext[:, -1], axis=-1)))
        with torch.no_grad():
            tl, tc, tpos = M.prefill(params, cfg, _torch(batch), MAX_LEN)
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


@pytest.mark.parametrize("server", [False, True])
def test_serve_cli_runs_whisper_on_cpu(server, capsys):
    from repro_torch.launch import serve

    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--gen", "3", "--prompt-len", "8",
            "--batch", "2"] + (["--server", "--tenants", "2"] if server else [])
    assert serve.main(args) == 0
    out = capsys.readouterr().out
    assert "sample token ids" in out and ("0 fallbacks" in out) == server


def test_prompt_batch_gives_encdec_seeded_frames():
    from repro_torch.launch.serve import prompt_batch

    cfg = reduced(get_config(ARCH))
    a, b = (prompt_batch(cfg, 2, 8, 5, "cpu") for _ in range(2))
    assert a["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert torch.equal(a["frames"], b["frames"]) and torch.equal(a["tokens"], b["tokens"])
    assert set(prompt_batch(reduced(get_config("qwen2.5-3b")), 2, 8, 5, "cpu")) == {"tokens"}


def test_train_launcher_lowers_whisper_loss_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as LT

    assert LT.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "12",
                    "--seq", "32", "--batch", "4", "--ckpt-dir", str(tmp_path)]) == 0
    assert "family=encdec" in capsys.readouterr().out


def test_train_region_runs_the_decoder_alone(pair):
    """The per-layer train region's embed task is the reference's: token
    embeddings alone (no sinusoids), and no encoder output reaches the
    blocks (the reference's optimizer task then fails on the missing encoder
    gradients). Its loss is that decoder's CE, through the final LayerNorm,
    and the parameters no task reaches get zero gradients (AdamW's decay
    alone moves them)."""
    from repro_torch.core import reset_registry
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.training import make_tdg_train_region

    reset_registry()
    _, _, cfg, model = pair
    params = {k: v.clone() for k, v in M.params_of(model).items()}
    tokens = torch.from_numpy(_batch(cfg, 12)["tokens"])
    with torch.no_grad():
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        x = L.embed(model.embed, tokens, cfg.compute_dtype)
        x, _, _ = T.decoder_stack(model.layers, cfg, x, pos)   # no enc_out
        h = T.norm(cfg, model.final_norm, x)
        labels, mask = M.shifted_labels(tokens)
        logits = L.unembed(model.head, h, cfg.compute_dtype)
        ce = ((torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None].long())[..., 0])
              * mask).sum() / mask.sum()
    assert isinstance(model.final_norm, L.LayerNorm) and cfg.padded_vocab == cfg.vocab_size
    opt = adamw(1e-3)
    out = make_tdg_train_region(cfg, opt)(params=params, opt_state=opt.init(params),
                                          tokens=tokens)
    np.testing.assert_allclose(float(out["loss"]), float(ce), atol=1e-5, rtol=1e-5)
    p0 = M.params_of(model)
    for k in ("encoder.0.attn.wq.w", "enc_norm.scale", "layers.1.cross.wo.w"):
        torch.testing.assert_close(out["params"][k], p0[k] * (1 - 1e-3 * 0.1))
    assert not torch.allclose(out["params"]["layers.1.mlp.up.w"], p0["layers.1.mlp.up.w"])
    reset_registry()
