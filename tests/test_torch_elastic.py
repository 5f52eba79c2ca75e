"""Elastic restarts in the port (``repro_torch.runtime.elastic``) against
``repro.runtime.elastic``.

``elastic_restart_plan`` is the reference's arithmetic, dict for dict over
a grid. ``reshard_checkpoint`` places a host tree on a new mesh by the
partition rules (the reference's ``device_put`` with ``param_shardings``;
the reference's own round trip is the 1 x 1 case), and
``gather_checkpoint`` assembles it whole where the single controller's
train step holds it. A run checkpointed on a 2 x 2 host mesh and resumed on
a 1 x 2 mesh gives the uninterrupted run's losses within 2e-5.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_small_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import (elastic_restart_plan, gather_checkpoint,  # noqa: E402
                                 reshard_checkpoint)
from repro_torch.sharding import partition as P_  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

RESUME_TOL = 2e-5


@pytest.fixture(autouse=True)
def _init_independent_of_the_process(monkeypatch):
    """ROADMAP C1: CRC-32 in place of the reference's salted ``hash``."""
    monkeypatch.setattr(JL, "hash", lambda s: zlib.crc32(str(s).encode()), raising=False)


GRID = [(256, new, batch) for new in (1, 2, 3, 5, 7, 128, 192, 255)
        for batch in (1, 4, 6, 256, 1000)]


@pytest.mark.parametrize("old,new,batch", GRID)
def test_restart_plan_equals_the_reference(old, new, batch):
    assert elastic_restart_plan(old, new, batch) == jelastic.elastic_restart_plan(old, new, batch)


@pytest.mark.parametrize("new", [0, -2])
def test_restart_plan_refuses_no_chips(new):
    with pytest.raises(ValueError):
        jelastic.elastic_restart_plan(4, new, 8)
    with pytest.raises(ValueError, match="positive"):
        elastic_restart_plan(4, new, 8)


def test_reshard_roundtrip_the_reference_case():
    """The reference's ``test_reshard_checkpoint_roundtrip``: a host numpy
    tree on a 1 x 1 mesh, equal to its reference placement."""
    mesh = make_small_mesh(1, 1, device="cpu")
    jmesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    tree = {"table": np.ones((16, 8), np.float32)}
    out = reshard_checkpoint(tree, mesh)
    jout = jelastic.reshard_checkpoint(tree, jmesh)
    assert tuple(out["table"].spec) == tuple(jout["table"].sharding.spec)
    np.testing.assert_allclose(out["table"].parts[0].numpy(), 1.0)
    np.testing.assert_allclose(gather_checkpoint(out, mesh, "cpu")["table"].numpy(),
                               np.asarray(jout["table"]))


def _state(cfg, seed=0):
    params = M.params_of(M.init_params(cfg, torch.Generator().manual_seed(seed)))
    opt = adamw(1e-2)
    state = opt.init(params)
    for t in (*state["mu"].values(), *state["nu"].values()):
        t.normal_(generator=torch.Generator().manual_seed(seed + 1))
    state["step"].fill_(7)
    return {"params": params, "opt_state": state}


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1), (4, 2)])
def test_reshard_then_gather_is_the_tree(shape):
    cfg = reduced(get_config("qwen2.5-3b"))
    tree = _state(cfg)
    mesh = make_small_mesh(*shape, device="cpu")
    placed = reshard_checkpoint(tree, mesh)
    back = gather_checkpoint(placed, mesh, "cpu")
    for group in ("params", "opt_state"):
        flat_a = dict(_leaves(tree[group]))
        flat_b = dict(_leaves(back[group]))
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert torch.equal(flat_a[k], flat_b[k]), k


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_moments_shard_as_their_params():
    cfg = reduced(get_config("qwen2.5-3b"))
    tree = _state(cfg)
    mesh = make_small_mesh(2, 2, device="cpu")
    placed = reshard_checkpoint(tree, mesh)
    specs = P_.param_pspecs(tree["params"], mesh)
    for name, prm in tree["params"].items():
        want = P_.sanitize_spec(tuple(prm.shape), specs[name], mesh)
        for group in (placed["params"], placed["opt_state"]["mu"], placed["opt_state"]["nu"]):
            assert group[name].spec == want
            assert len(group[name].parts) == 4
    wq = placed["params"]["layers.0.attn.wq.w"]
    assert wq.spec == P_.PartitionSpec("data", "model")
    assert wq.parts[0].shape == (cfg.d_model // 2, cfg.num_heads * cfg.head_dim // 2)
    assert placed["opt_state"]["step"].spec == P_.PartitionSpec()


def test_checkpoint_on_2x2_resumed_on_1x2_gives_the_uninterrupted_losses(tmp_path):
    cfg = reduced(get_config("qwen2.5-3b"))
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    batches = [{"tokens": torch.from_numpy(ds.batch(i)["tokens"])} for i in range(4)]
    opt = adamw(1e-3)

    def fresh():
        params = M.params_of(M.init_params(cfg, torch.Generator().manual_seed(0)))
        return params, opt.init(params)

    big, small = make_small_mesh(2, 2, device="cpu"), make_small_mesh(1, 2, device="cpu")
    params, state = fresh()
    step = make_train_step(cfg, opt, mesh=big)
    uninterrupted = [float(step(params, state, b)[2]["loss"]) for b in batches]

    params, state = fresh()
    losses = [float(step(params, state, b)[2]["loss"]) for b in batches[:2]]
    ckpt = Checkpointer(tmp_path)
    ckpt.save({"params": params, "opt_state": state}, step=2, blocking=True)
    del params, state
    restored, at = ckpt.restore(None)
    assert at == 2
    assert elastic_restart_plan(4, 2, 4) == {"old_chips": 4, "new_chips": 2,
                                             "per_device_batch": 2, "grad_accum": 1}
    tree = gather_checkpoint(reshard_checkpoint(restored, small), small, "cpu")
    params, state = tree["params"], tree["opt_state"]
    assert int(state["step"]) == 2
    resumed = make_train_step(cfg, opt, mesh=small)
    losses += [float(resumed(params, state, b)[2]["loss"]) for b in batches[2:]]
    np.testing.assert_allclose(losses, uninterrupted, rtol=RESUME_TOL, atol=RESUME_TOL)
    assert losses[:2] == uninterrupted[:2]
