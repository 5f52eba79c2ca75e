"""The port's dense, VLM and MoE families beyond slice 1's models against
the JAX reference: glm4-9b (QKV bias, half-width rotary), minicpm-2b (MHA,
mu-parametrized scales, tied embeddings), minitron-8b (relu² MLP),
chameleon-34b (VLM: dense with qk-norm) and llama4-scout-17b-a16e (16
experts top-1 with a shared expert, chunked attention).

Each at ``reduced()`` in f32, with the JAX parameters carried across by
``params_from_jax``: the configs field by field, prefill logits and
caches, three decode steps, greedy tokens (identical), ``loss_fn``'s loss
and gradients against ``jax.value_and_grad``, and the decode step under
``torch.func.vmap``; at atol = rtol = 1e-4 (the two frameworks sum f32
products in different orders). Prompts of 40 tokens pass llama4's reduced
32-token attention chunk. Also the gelu (tanh) and relu² MLPs, and which
kernel each new model's shapes pick on the card.
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
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.configs.base import PORT_FIELDS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

FAMILY_ARCHS = ["glm4-9b", "minicpm-2b", "minitron-8b", "chameleon-34b",
                "llama4-scout-17b-a16e"]
NEW_ARCHS = FAMILY_ARCHS + ["hymba-1.5b", "whisper-small"]
TOL = 1e-4
MAX_LEN = 48
_PAIRS: dict = {}


def _pair(arch):
    """(JAX config, JAX params, port config, port model): the same weights."""
    if arch not in _PAIRS:
        jcfg = jax_reduced(jax_get_config(arch))
        cfg = reduced(get_config(arch))
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        model = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
        _PAIRS[arch] = (jcfg, jparams, cfg, model)
    return _PAIRS[arch]


def _tokens(seed, B=2, S=40):
    return np.random.default_rng(seed).integers(2, 256, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_caches(tc, jc):
    for tcache, jcache in zip(tc, jc, strict=True):
        assert set(tcache) == set(jcache)
        for k in ("k", "v"):
            _close(tcache["attn"][k], jcache["attn"][k])
        np.testing.assert_array_equal(tcache["attn"]["pos"].numpy(),
                                      np.asarray(jcache["attn"]["pos"]))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_configs_match_reference(arch):
    """Every field the port has is the reference's, at full width and reduced."""
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (reduced(get_config(arch)), jax_reduced(jax_get_config(arch)))):
        for f in dataclasses.fields(cfg):
            if f.name in PORT_FIELDS:   # the port's own, at their defaults here
                assert getattr(cfg, f.name) == f.default, f.name
            else:
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert (cfg.padded_vocab, cfg.expert_d_ff) == (jcfg.padded_vocab, jcfg.expert_d_ff)
    assert set(NEW_ARCHS) < set(ARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_logits_and_caches_match(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    toks = _tokens(0)
    jl, jc, jpos = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc, tpos = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                 max_len=MAX_LEN)
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _close_caches(tc, jc)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_steps_match(arch):
    jcfg, jparams, cfg, params = _pair(arch)
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


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_greedy_decode_tokens_identical(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    toks = _tokens(3, B=3)
    want = JM.greedy_decode(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 6, MAX_LEN)
    with torch.no_grad():
        got = M.greedy_decode(params, cfg, {"tokens": torch.from_numpy(toks)}, 6, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match(arch):
    jcfg, jparams, cfg, model = _pair(arch)
    toks = _tokens(4, S=32)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}), has_aux=True)(jparams)
    diff = {k: v.clone().requires_grad_() for k, v in M.params_of(model).items()}
    loss, m = M.loss_fn(M.bind(cfg, diff), cfg, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, list(diff.values()))
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    want = M.flatten_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want) == set(diff)
    for k, g in zip(diff, grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_step_is_vmappable_across_requests(arch):
    _, _, cfg, params = _pair(arch)
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
            torch.testing.assert_close(bcaches[-1]["attn"]["k"][i], scaches[-1]["attn"]["k"],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_and_param_count_match(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    toks = _tokens(5, S=12)
    jl, jaux = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, aux = M.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    _close(logits, jl)
    _close(aux, jaux)
    assert M.param_count(params) == JM.param_count(jparams)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu", "relu2"])
def test_mlp_activations_match(mlp):
    """gelu is the tanh approximation (``jax.nn.gelu``'s default); only
    swiglu has a gate."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("minitron-8b")), mlp=mlp)
    cfg = dataclasses.replace(reduced(get_config("minitron-8b")), mlp=mlp)
    jp = JL.mlp_init(jax.random.PRNGKey(1), jcfg)
    p = L.MLP(cfg, "cpu")
    assert (p.gate is None) == (mlp != "swiglu") and ("gate" in jp) == (mlp == "swiglu")
    for name, sub in jp.items():
        getattr(p, name).w.copy_(torch.from_numpy(np.array(sub["w"])))
    x = np.random.default_rng(6).standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 3
    _close(L.mlp_apply(p, cfg, torch.from_numpy(x)), JL.mlp_apply(jp, jcfg, jnp.asarray(x)),
           2e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 241).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4          # the erf form is another function


SM90_FA, FIRST_FA = fa.KERNELS
SM90_RMS, FIRST_RMS = rms.KERNELS
SM90_GMM, _ = gmm.KERNELS
SM90_SSD, _ = ssd_scan.KERNELS


@pytest.mark.parametrize("arch,rms_widths,first_rms", [
    ("glm4-9b", [4096], []),
    ("minicpm-2b", [2304], []),
    ("minitron-8b", [4096], []),
    ("chameleon-34b", [8192, 128], []),           # and the qk-norm over head dim 128
    ("llama4-scout-17b-a16e", [5120], []),
    ("hymba-1.5b", [3200, 1600], []),              # the gated SSM norm; d_model 1600
    ("whisper-small", [], [])])                    # LayerNorm only: plain torch
def test_kernel_choice_at_the_new_models_shapes(arch, rms_widths, first_rms):
    """bf16 as served. hymba's d_model 1600 (200 16-byte vectors, not a
    multiple of 16 of them) takes the register-resident RMSNorm too: no
    model's shapes reach a first design."""
    cfg = get_config(arch)
    bf16 = torch.bfloat16
    assert fa.kernel_for(bf16, cfg.head_dim) == SM90_FA
    assert fa.kernel_for(torch.float32, cfg.head_dim) == SM90_FA    # the f32 parity runs
    assert [rms.kernel_for(bf16, d) for d in rms_widths] == [SM90_RMS] * len(rms_widths)
    assert [rms.kernel_for(torch.float32, d) for d in rms_widths] == [SM90_RMS] * len(rms_widths)
    assert [rms.kernel_for(bf16, d) for d in first_rms] == [FIRST_RMS] * len(first_rms)
    model = M._skeleton(cfg)
    widths = {m.scale.shape[0] for m in model.modules() if isinstance(m, L.RMSNorm)}
    assert widths == set(rms_widths) | set(first_rms)
    if cfg.num_experts:
        for d, f in ((cfg.d_model, cfg.expert_d_ff), (cfg.expert_d_ff, cfg.d_model)):
            assert gmm.kernel_for(bf16, d, f) == SM90_GMM
    if cfg.hybrid_ssm:
        assert ssd_scan.kernel_for(cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk) == SM90_SSD
        assert rms.kernel_for(torch.float32, cfg.d_model) == SM90_RMS   # f32 checks
