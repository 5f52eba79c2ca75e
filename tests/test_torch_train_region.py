"""The port's per-layer TDG train region against the fused step and the JAX
package on the CPU (the reference's ``tests/test_training.py`` region tests,
ported, and the pad-column case).

``make_tdg_train_region`` runs the step as ``2n + 5`` tasks (embed,
per-layer forward, head loss, head backward, per-layer recompute-VJP
backward, embed backward, optimizer update). Its updated params must equal
the fused step's and the JAX region's within atol 1e-3, rtol 5e-3 (the
reference's tolerance for AdamW's sqrt-denominator noise), its loss within
rtol 1e-4; the eager executor's within rtol 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training import make_tdg_train_region as jax_region  # noqa: E402
from repro.training import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import EagerExecutor, reset_registry, topo_waves  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import make_tdg_train_region, make_train_step  # noqa: E402

TOL = 1e-4
P_ATOL, P_RTOL = 1e-3, 5e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _fresh_region_registry():
    reset_registry()
    yield
    reset_registry()


def _pair(arch, **kw):
    jcfg = jax_reduced(jax_get_config(arch), **kw)
    cfg = reduced(get_config(arch), **kw)
    jparams = JM.init_params(jcfg, KEY)
    params = M.params_of(M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                           cfg, "cpu"))
    return jcfg, jparams, cfg, params


def _close_params(got: dict, jtree, cfg, atol=P_ATOL, rtol=P_RTOL):
    want = M.flatten_jax(jax.tree_util.tree_map(np.asarray, jtree), cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].astype(np.float32),
                                   atol=atol, rtol=rtol, err_msg=k)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _region_setup(arch="qwen2.5-3b", **kw):
    jcfg, jparams, cfg, params = _pair(arch, num_layers=2, tie_embeddings=False, **kw)
    toks = np.array(jax.random.randint(KEY, (2, 16), 2, cfg.vocab_size), np.int32)
    return jcfg, jparams, cfg, params, toks


def _assert_params_close(a: dict, b: dict):
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=P_ATOL, rtol=P_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m"])
def test_tdg_step_equals_fused_step(arch):
    """The per-layer region's updated params equal the fused step's (same
    math, different orchestration), at record and at replay."""
    _, _, cfg, params, toks = _region_setup(arch)
    opt = adamw(1e-2)
    tokens = torch.from_numpy(toks)
    p_ref, _, m_ref = make_train_step(cfg, opt)(_clone(params), opt.init(params),
                                               {"tokens": tokens})
    region = make_tdg_train_region(cfg, opt)
    out = region(params=params, opt_state=opt.init(params), tokens=tokens)
    assert region.records == 1
    np.testing.assert_allclose(float(out["loss"]), float(m_ref["loss"]), rtol=TOL)
    _assert_params_close(out["params"], p_ref)
    assert int(out["opt_state"]["step"]) == 1
    out2 = region(params=params, opt_state=opt.init(params), tokens=tokens)
    assert region.replays == 1
    _assert_params_close(out2["params"], out["params"])


def test_tdg_step_eager_executor_matches():
    _, _, cfg, params, toks = _region_setup()
    opt = adamw(1e-2)
    tokens = torch.from_numpy(toks)
    region = make_tdg_train_region(cfg, opt, name="tdg_eager_check")
    out = region(params=params, opt_state=opt.init(params), tokens=tokens)
    ex = EagerExecutor(region.tdg, n_workers=4)
    out_e = ex.run({"params": params, "opt_state": opt.init(params), "tokens": tokens},
                   outputs=["loss", "params"])
    np.testing.assert_allclose(float(out_e["loss"]), float(out["loss"]), rtol=1e-5)
    _assert_params_close(out_e["params"], out["params"])


def test_tdg_step_structure():
    cfg = reduced(get_config("qwen2.5-3b"), num_layers=3, tie_embeddings=False)
    opt = adamw(1e-2)
    region = make_tdg_train_region(cfg, opt, name="tdg_struct")
    params = {k: torch.empty(v.shape, device="meta")
              for k, v in M.Model(cfg, "meta").named_parameters()}
    region.build_static(params=params, opt_state=opt.init(params),
                        tokens=torch.empty((2, 16), dtype=torch.int32, device="meta"))
    n = cfg.num_layers
    # embed + n fwd + head_loss + head_bwd + n bwd + embed_bwd + opt
    assert region.tdg.num_tasks == 2 * n + 5
    waves = topo_waves(region.tdg)
    names = [region.tdg.tasks[t].label() for t in waves[1]]
    assert "fwd_L0" in names          # fwd chain starts in wave 1
    labels = [[region.tdg.tasks[t].label() for t in w] for w in waves]
    assert labels[n + 1] == ["head_loss", "head_bwd"]    # the head's two tasks share a wave
    assert labels[-2:] == [["embed_bwd"], ["opt_update"]]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b"])   # dense: the pad-column case
def test_tdg_region_matches_jax_region(arch):
    jcfg, jparams, cfg, params, toks = _region_setup(arch)
    jopt, opt = jax_adamw(1e-2), adamw(1e-2)
    jout = jax_region(jcfg, jopt, name=f"jax region {arch}")(
        params=jparams, opt_state=jopt.init(jparams), tokens=jnp.asarray(toks))
    out = make_tdg_train_region(cfg, opt)(params=params, opt_state=opt.init(params),
                                          tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=TOL)
    _close_params(out["params"], jout["params"], cfg)


def test_pad_columns_region_and_fused_each_match_jax():
    """vocab_size 200 pads to 256: the region's CE spans the 56 pad columns
    (the reference's head_loss / head_bwd do not mask them) and the fused
    step's does not, so the two differ, each as its JAX counterpart does."""
    jcfg, jparams, cfg, params, toks = _region_setup(vocab_size=200)
    assert cfg.padded_vocab == 256
    jopt, opt = jax_adamw(1e-2), adamw(1e-2)
    tokens = torch.from_numpy(toks)
    jout = jax_region(jcfg, jopt, name="jax pad region")(
        params=jparams, opt_state=jopt.init(jparams), tokens=jnp.asarray(toks))
    out = make_tdg_train_region(cfg, opt, name="pad region")(
        params=params, opt_state=opt.init(params), tokens=tokens)
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=TOL)
    _close_params(out["params"], jout["params"], cfg)
    jp, _, jm = jax_train_step(jcfg, jopt)(jparams, jopt.init(jparams), {"tokens": jnp.asarray(toks)})
    p, _, m = make_train_step(cfg, opt)(_clone(params), opt.init(params), {"tokens": tokens})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL)
    _close_params(p, jp, cfg)
    gap, jgap = float(out["loss"]) - float(m["loss"]), float(jout["loss"]) - float(jm["loss"])
    assert gap > 1e-3 and abs(gap - jgap) <= 1e-4 * abs(jgap)
