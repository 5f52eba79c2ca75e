"""The port's training path against the JAX package on the CPU.

``reduced()`` configs in f32 with the JAX parameters (and, for multi-step
parity, the JAX AdamW state) carried across by ``params_from_jax`` /
``opt_state_from_jax``. ``loss_fn`` and its gradient per leaf must agree
within atol = rtol = 1e-4, for the dense, MoE and SSM families, with and
without ``loss_chunk``. Train steps: the loss within rtol 1e-4, params and
moments within atol 1e-3, rtol 5e-3 (the reference's own tolerance for
AdamW's sqrt-denominator noise). Then the reference's fused-step test and
the training entry points; the per-layer region's tests are in
``test_torch_train_region.py``.
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
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

TOL = 1e-4
P_ATOL, P_RTOL = 1e-3, 5e-3
KEY = jax.random.PRNGKey(0)


def _pair(arch, **kw):
    jcfg = jax_reduced(jax_get_config(arch), **kw)
    cfg = reduced(get_config(arch), **kw)
    jparams = JM.init_params(jcfg, KEY)
    params = M.params_of(M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                           cfg, "cpu"))
    return jcfg, jparams, cfg, params


def _tokens(seed, B=2, S=32, vocab=256):
    return np.random.default_rng(seed).integers(2, vocab, (B, S)).astype(np.int32)


def _flat(jtree, cfg):
    return M.flatten_jax(jax.tree_util.tree_map(np.asarray, jtree), cfg)


def _close_params(got: dict, jtree, cfg, atol=P_ATOL, rtol=P_RTOL):
    want = _flat(jtree, cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(), want[k].astype(np.float32),
                                   atol=atol, rtol=rtol, err_msg=k)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


# ---------------------------------------------------------------- loss_fn

LOSS_CASES = [("qwen2.5-3b", 0), ("qwen2.5-3b", 8), ("qwen3-moe-30b-a3b", 0),
              ("qwen3-moe-30b-a3b", 16), ("mamba2-370m", 0), ("mamba2-370m", 8)]


@pytest.mark.parametrize("arch,chunk", LOSS_CASES)
def test_loss_fn_and_gradients_match(arch, chunk):
    jcfg, jparams, cfg, params = _pair(arch, loss_chunk=chunk)
    toks = _tokens(1)
    mask = (np.random.default_rng(2).random(toks.shape) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jbatch), has_aux=True))(jparams)
    batch = {"tokens": torch.from_numpy(toks), "loss_mask": torch.from_numpy(mask)}
    diff = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, m = M.loss_fn(M.bind(cfg, diff), cfg, batch)
    grads = dict(zip(diff, torch.autograd.grad(loss, list(diff.values()))))
    for k in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    _close_params(grads, jgrads, cfg, atol=TOL, rtol=TOL)


def test_remat_and_chunked_loss_give_the_same_gradients():
    _, _, cfg, params = _pair("qwen2.5-3b")
    batch = {"tokens": torch.from_numpy(_tokens(3))}

    def grads(c):
        diff = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = M.loss_fn(M.bind(c, diff), c, batch)
        return loss.detach(), torch.autograd.grad(loss, list(diff.values()))

    l0, g0 = grads(cfg)
    l1, g1 = grads(dataclasses.replace(cfg, remat="full", loss_chunk=8))
    assert abs(l0.item() - l1.item()) <= 1e-6
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_forward_and_param_count_match():
    jcfg, jparams, cfg, params = _pair("qwen2.5-3b")
    toks = _tokens(4)
    jl, jaux = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, aux = M.forward(M.model_of(cfg, params), cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert M.param_count(params) == JM.param_count(jparams)
    assert M.param_count(M.model_of(cfg, params)) == M.param_count(params)


def test_functional_view_round_trip_shares_storage():
    _, _, cfg, params = _pair("qwen3-moe-30b-a3b")
    model = M.model_of(cfg, params)
    back = M.params_of(model)
    assert list(back) == list(params)
    assert all(back[k].data_ptr() == params[k].data_ptr() for k in params)
    view = M.bind(cfg, params)
    assert view.layers[1].attn.wq.w is params["layers.1.attn.wq.w"]
    assert view.layers[0].attn.wq.b is None and view.head is not None
    block = M.bind(cfg, params, layer=1)
    assert block.moe.experts.up.w is params["layers.1.moe.experts.up.w"]


# ---------------------------------------------------------------- train steps

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m"])
def test_fused_steps_match(arch):
    """One JAX step, its state carried across (opt_state_from_jax), then
    three more steps on both sides: loss per step, then params and moments."""
    jcfg, jparams, cfg, _ = _pair(arch)
    jopt, opt = jax_adamw(1e-2), adamw(1e-2)
    jstep = jax.jit(jax_train_step(jcfg, jopt))
    step = make_train_step(cfg, opt)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2))
    js = jopt.init(jparams)
    jparams, js, _ = jstep(jparams, js, {"tokens": jnp.asarray(ds.batch(0)["tokens"])})
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = M.params_of(M.params_from_jax(np_tree(jparams), cfg, "cpu"))
    state = M.opt_state_from_jax(np_tree(js), cfg, "cpu")
    assert int(state["step"]) == 1
    for i in range(1, 4):
        b = ds.batch(i)["tokens"]
        jparams, js, jm = jstep(jparams, js, {"tokens": jnp.asarray(b)})
        params, state, m = step(params, state, {"tokens": torch.from_numpy(b)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=TOL)
    assert int(state["step"]) == int(js["step"]) == 4
    _close_params(params, jparams, cfg)
    _close_params(state["mu"], js["mu"], cfg)
    _close_params(state["nu"], js["nu"], cfg)


def test_fused_step_updates_in_place():
    _, _, cfg, params = _pair("qwen2.5-3b")
    opt = adamw(1e-2)
    state = opt.init(params)
    ptrs = {k: v.data_ptr() for k, v in params.items()}
    before = _clone(params)
    p2, s2, _ = make_train_step(cfg, opt)(params, state, {"tokens": torch.from_numpy(_tokens(5))})
    assert p2 is params and s2 is state and int(state["step"]) == 1
    assert all(params[k].data_ptr() == ptrs[k] for k in params)
    assert any(not torch.equal(params[k], before[k]) for k in params)


# ---------------------------------------------------------------- the reference's training tests

def test_fused_step_decreases_loss():
    _, _, cfg, params = _pair("qwen2.5-3b")
    opt = adamw(1e-2)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
    losses = []
    for i in range(30):
        params, state, m = step(params, state, {"tokens": torch.from_numpy(ds.batch(i)["tokens"])})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# ---------------------------------------------------------------- entry points

def test_launcher_smoke_on_cpu_lowers_the_loss(tmp_path, capsys):
    from repro_torch.launch import train as LT

    state, report, losses, _ = LT.run(
        ["--smoke", "--device", "cpu", "--steps", "20", "--batch", "4", "--seq", "64",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"])
    assert report["completed_steps"] == 20 and report["checkpoints"] == 2
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert int(state.opt_state["step"]) == 20
    assert "loss" in capsys.readouterr().out


def test_launcher_without_a_card_raises(tmp_path):
    from repro_torch.launch import train as LT

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        LT.main(["--smoke", "--steps", "2", "--ckpt-dir", str(tmp_path)])


def test_train_tiny_lm_example_and_config_registry(tmp_path):
    from repro_torch import configs
    from repro_torch.examples import train_tiny_lm

    assert train_tiny_lm.main(["--device", "cpu", "--steps", "10", "--seq", "32",
                               "--ckpt-dir", str(tmp_path)]) == 0
    configs.register(train_tiny_lm.TINY_100M)
    assert configs.get_config("tiny-lm-100m") is train_tiny_lm.TINY_100M
    assert "tiny-lm-100m" in configs.archs()
    with pytest.raises(ValueError):
        configs.register(dataclasses.replace(train_tiny_lm.TINY_100M, name="qwen2.5-3b"))
