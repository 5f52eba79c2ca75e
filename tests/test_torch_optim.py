"""The port's training substrates against the JAX package on the CPU:
AdamW (functional and in place), the LR schedules, int8 gradient
compression with error feedback, the data pipeline, the checkpointer and
the fault-tolerant supervisor (the reference's ``test_substrates.py``,
ported, plus differential checks on the same numpy inputs).

AdamW and the schedules must agree with the reference within rtol 1e-6
(the same f32 formulas); the data pipeline's batches bit for bit.
"""
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch.checkpoint import Checkpointer, latest_step, load_pytree, save_pytree  # noqa: E402
from repro_torch.data import (DataConfig, MixtureDataset, SyntheticLM,  # noqa: E402
                              make_loader, pack_documents)
from repro_torch.optim import adamw, apply_updates, global_norm, warmup_cosine, wsd  # noqa: E402
from repro_torch.optim.compress import (compress_leaf, decompress_leaf, ef_step,  # noqa: E402
                                        init_error_feedback)
from repro_torch.runtime import RunState, StragglerPolicy, run_with_recovery  # noqa: E402
from repro_torch.runtime.fault_tolerance import StepTimer  # noqa: E402

RTOL = 1e-6


def _tree(rng, scale=1.0):
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}, "e": (1,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return make(shapes)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree(got, want, rtol=RTOL, atol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree(got[k], want[k], rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- AdamW

@pytest.mark.parametrize("clip,scale", [(1.0, 1.0), (1.0, 0.01), (0.0, 3.0)])
def test_adamw_matches_reference(clip, scale):
    """Three steps from one random tree: updates, moments, step, grad norm
    and the new params, functional and in place, against the reference."""
    rng = np.random.default_rng(0)
    params_np = _tree(rng)
    jopt = joptim.adamw(joptim.warmup_cosine(1e-2, 2, 10), grad_clip=clip)
    topt = adamw(warmup_cosine(1e-2, 2, 10), grad_clip=clip)
    jp, tp = _to_jax(params_np), _to_torch(params_np)
    js, ts = jopt.init(jp), topt.init(tp)
    tp_in, ts_in = _to_torch(params_np), topt.init(_to_torch(params_np))
    for _ in range(3):
        grads_np = _tree(rng, scale)
        ju, js, jm = jopt.update(_to_jax(grads_np), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts, tm = topt.update(_to_torch(grads_np), ts, tp)
        tp = apply_updates(tp, tu)
        _assert_tree(tu, ju)
        _assert_tree(tp, jp)
        _assert_tree(ts["mu"], js["mu"])
        _assert_tree(ts["nu"], js["nu"])
        assert int(ts["step"]) == int(js["step"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=RTOL)
        im = topt.update_(_to_torch(grads_np), ts_in, tp_in)     # in place
        _assert_tree(tp_in, tp, rtol=0)
        _assert_tree(ts_in["mu"], ts["mu"], rtol=0)
        _assert_tree(ts_in["nu"], ts["nu"], rtol=0)
        assert int(ts_in["step"]) == int(ts["step"])
        assert float(im["grad_norm"]) == float(tm["grad_norm"])


def test_adamw_bf16_params_cast_update_first():
    """bf16 params: the update is cast to bf16 before the f32 add, as in the
    reference; moments stay f32."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((64,)).astype(np.float32)
    g = rng.standard_normal((64,)).astype(np.float32)
    jopt, topt = joptim.adamw(3e-2), adamw(3e-2)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).bfloat16()}
    js, ts = jopt.init(jp), topt.init(tp)
    ju, js, _ = jopt.update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp)
    tu, ts, _ = topt.update({"w": torch.from_numpy(g).bfloat16()}, ts, tp)
    assert tu["w"].dtype == torch.bfloat16 and ts["mu"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(tu["w"].float().numpy(), np.asarray(ju["w"], np.float32))
    np.testing.assert_array_equal(apply_updates(tp, tu)["w"].float().numpy(),
                                  np.asarray(joptim.apply_updates(jp, ju)["w"], np.float32))


def test_adamw_converges_quadratic():
    opt = adamw(0.1, weight_decay=0.0)
    params = {"w": torch.ones(4) * 5.0}
    state = opt.init(params)
    target = torch.tensor([1.0, -2.0, 3.0, 0.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        upd, state, _ = opt.update(g, state, params)
        params = apply_updates(params, upd)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_grad_clip_reports_the_unclipped_norm():
    opt = adamw(0.1, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    _, _, m = opt.update({"w": torch.full((3,), 100.0)}, opt.init(params), params)
    assert float(m["grad_norm"]) > 100
    np.testing.assert_allclose(float(global_norm({"w": torch.full((3,), 100.0)})),
                               100 * 3 ** 0.5, rtol=1e-6)


def test_adamw_state_mismatch_raises():
    opt = adamw(0.1)
    params = {"a": torch.zeros(2), "b": torch.zeros(2)}
    state = opt.init({"b": torch.zeros(2), "a": torch.zeros(2)})
    with pytest.raises(ValueError):
        opt.update({"a": torch.ones(2), "b": torch.ones(2)}, state, params)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("make_j,make_t,args", [
    (joptim.warmup_cosine, warmup_cosine, (1.0, 10, 100)),
    (joptim.warmup_cosine, warmup_cosine, (3e-3, 2, 20, 0.05)),
    (joptim.wsd, wsd, (1.0, 10, 50, 20)),
    (joptim.wsd, wsd, (3e-4, 1, 7, 2, 0.1)),
])
def test_schedule_step_by_step(make_j, make_t, args):
    jl, tl = make_j(*args), make_t(*args)
    steps = torch.arange(0, 130, dtype=torch.int32)
    got = tl(steps)
    assert got.dtype == torch.float32 and got.device == steps.device
    want = np.asarray([float(jl(s)) for s in range(130)], np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)
    assert float(tl(5)) == pytest.approx(float(jl(5)), rel=RTOL)


def test_schedule_values():
    lr = warmup_cosine(1.0, 10, 100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(100)) == pytest.approx(0.1, abs=1e-6)
    lr = wsd(1.0, 10, 50, 20)
    assert float(lr(5)) == pytest.approx(0.5)
    assert float(lr(30)) == pytest.approx(1.0)
    assert float(lr(59)) == pytest.approx(1.0)
    assert float(lr(80)) == pytest.approx(0.01, rel=0.2)


# ---------------------------------------------------------------- compression

def test_compression_matches_reference():
    g = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    q, s = compress_leaf(torch.from_numpy(g))
    jq, js = jcompress.compress_leaf(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=RTOL)
    err = float((decompress_leaf(q, s) - torch.from_numpy(g)).abs().max())
    assert err <= float(s) * 0.5 + 1e-6


def test_error_feedback_matches_reference_and_is_unbiased():
    rng = np.random.default_rng(3)
    grads = [{"w": rng.standard_normal(64).astype(np.float32) * 0.003} for _ in range(20)]
    ef, jef = init_error_feedback(_to_torch(grads[0])), jcompress.init_error_feedback(
        _to_jax(grads[0]))
    for g in grads:
        dq, ef = ef_step(_to_torch(g), ef)
        jdq, jef = jcompress.ef_step(_to_jax(g), jef)
        _assert_tree(dq, jdq, rtol=1e-5, atol=1e-9)
        _assert_tree(ef, jef, rtol=1e-5, atol=1e-9)
    true_g = {"w": torch.full((64,), 0.003)}
    ef = init_error_feedback(true_g)
    applied = torch.zeros(64)
    for _ in range(50):
        dq, ef = ef_step(true_g, ef)
        applied = applied + dq["w"]
    np.testing.assert_allclose((applied / 50).numpy(), true_g["w"].numpy(), rtol=0.2)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=64, global_batch=4),
    dict(vocab_size=512, seq_len=128, global_batch=4, seed=3, mean_doc_len=40),
    dict(vocab_size=100, seq_len=32, global_batch=8, num_hosts=2, host_id=1),
])
def test_batches_bit_equal_to_reference(kw):
    ours, theirs = SyntheticLM(DataConfig(**kw)), jdata.SyntheticLM(jdata.DataConfig(**kw))
    for step in (0, 7, 123):
        a, b = ours.batch(step), theirs.batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    loader, jloader = make_loader(DataConfig(**kw), 5), jdata.make_loader(jdata.DataConfig(**kw), 5)
    for _ in range(2):
        np.testing.assert_array_equal(next(loader)["tokens"], next(jloader)["tokens"])


def test_mixture_and_packing_bit_equal_to_reference():
    comps = [DataConfig(vocab_size=50, seq_len=16, global_batch=2),
             DataConfig(vocab_size=50, seq_len=16, global_batch=2, seed=9)]
    mix = MixtureDataset([SyntheticLM(c) for c in comps], weights=[0.3, 0.7])
    jmix = jdata.MixtureDataset([jdata.SyntheticLM(jdata.DataConfig(**vars(c)))
                                 for c in comps], weights=[0.3, 0.7])
    for step in range(6):
        np.testing.assert_array_equal(mix.batch(step)["tokens"], jmix.batch(step)["tokens"])
    docs = [np.arange(2, 12), np.arange(2, 30)]
    toks, mask = pack_documents(docs, 2, 16, eos_id=1, pad_id=0)
    jtoks, jmask = jdata.pack_documents(docs, 2, 16, eos_id=1, pad_id=0)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(mask, jmask)
    assert (toks == 1).sum() >= 1


def test_data_addressing_and_host_sharding():
    cfg = DataConfig(vocab_size=100, seq_len=64, global_batch=4)
    ds = SyntheticLM(cfg)
    np.testing.assert_array_equal(ds.batch(7)["tokens"], ds.batch(7)["tokens"])
    assert not np.array_equal(ds.batch(8)["tokens"], ds.batch(7)["tokens"])
    k = dict(vocab_size=100, seq_len=32, global_batch=8, num_hosts=2)
    b0 = SyntheticLM(DataConfig(host_id=0, **k)).batch(0)
    b1 = SyntheticLM(DataConfig(host_id=1, **k)).batch(0)
    assert b0["tokens"].shape == (4, 32)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


# ---------------------------------------------------------------- checkpoints

def test_roundtrip_with_integrity(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.int32), "h": torch.randn(5).bfloat16()},
            "n": np.arange(4, dtype=np.int64), "s": 7}
    d = save_pytree(tree, tmp_path, 5)
    assert sorted(p.name for p in d.iterdir()) == ["_COMMITTED", "host_00000.npz",
                                                   "manifest.json"]
    out = load_pytree(tree, tmp_path, 5)
    assert torch.equal(out["a"], tree["a"]) and out["b"]["c"].dtype == torch.int32
    assert out["b"]["h"].dtype == torch.bfloat16 and torch.equal(out["b"]["h"], tree["b"]["h"])
    np.testing.assert_array_equal(out["n"], tree["n"])
    assert int(out["s"]) == 7
    assert latest_step(tmp_path) == 5
    import json
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["leaves"]["b/h"]["dtype"] == "bfloat16"


def test_torn_checkpoint_ignored(tmp_path):
    save_pytree({"a": torch.zeros(3)}, tmp_path, 1)
    d = pathlib.Path(tmp_path) / "step_000002"
    d.mkdir()
    (d / "host_00000.npz").write_bytes(b"garbage")       # no _COMMITTED
    assert latest_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError):
        load_pytree({"a": torch.zeros(3)}, tmp_path, 2)


def test_corruption_detected(tmp_path):
    tree = {"a": torch.arange(100, dtype=torch.float32)}
    d = save_pytree(tree, tmp_path, 3)
    np.savez(d / "host_00000.npz", a=np.arange(100, dtype=np.float32) + 1)
    with pytest.raises(IOError):
        load_pytree(tree, tmp_path, 3)


def test_async_checkpointer_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save({"x": torch.full((4,), float(s))}, s)
    ck.wait()
    ck._gc()
    assert latest_step(tmp_path) == 4
    assert sorted(p.name for p in pathlib.Path(tmp_path).iterdir()) == ["step_000003",
                                                                        "step_000004"]
    restored, step = ck.restore({"x": torch.zeros(4)})
    assert step == 4
    np.testing.assert_allclose(restored["x"].numpy(), 4.0)


def test_snapshot_is_taken_before_the_next_in_place_step(tmp_path):
    """The tree is copied at save(): an in-place update right after it does
    not reach the checkpoint the background thread writes."""
    w = torch.zeros(1 << 16)
    ck = Checkpointer(tmp_path)
    ck.save({"w": w}, 1)
    w.add_(1.0)
    ck.wait()
    restored, _ = ck.restore({"w": torch.empty(1 << 16)})
    assert float(restored["w"].abs().max()) == 0.0


def test_loads_model_params_the_jax_package_checkpointed(tmp_path):
    """A JAX model's f32 params (layers stacked), checkpointed by the JAX
    package, read by their names and carried into the port's model."""
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import model as JM
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M

    jcfg, cfg = jax_reduced(jax_get_config("qwen2.5-3b")), reduced(get_config("qwen2.5-3b"))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jckpt.save_pytree({"params": jparams}, tmp_path, 4)
    params = M.params_of(M.params_from_jax(load_pytree(None, tmp_path, 4)["params"], cfg, "cpu"))
    want = M.flatten_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    assert set(params) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(params[k].numpy(), v)


def test_loads_a_checkpoint_the_jax_package_wrote(tmp_path):
    tree = {"params": {"w": np.random.default_rng(4).standard_normal((4, 3)).astype(np.float32),
                       "layers": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)}},
            "opt_state": {"step": np.asarray(9, np.int32)}, "step": 12}
    jckpt.save_pytree(jax.tree_util.tree_map(jnp.asarray, tree), tmp_path, 12)
    template = {"params": {"w": torch.zeros(4, 3), "layers": {"b": torch.zeros(2, 3)}},
                "opt_state": {"step": torch.zeros((), dtype=torch.int32)}, "step": 0}
    out = load_pytree(template, tmp_path, 12)
    np.testing.assert_array_equal(out["params"]["w"].numpy(), tree["params"]["w"])
    assert int(out["opt_state"]["step"]) == 9 and int(out["step"]) == 12
    raw = load_pytree(None, tmp_path, 12)          # no template: the tree by its names
    np.testing.assert_array_equal(raw["params"]["layers"]["b"], tree["params"]["layers"]["b"])
    # and the other way round: the port's checkpoint loads in the JAX package
    save_pytree(template | {"step": 3}, tmp_path, 13)
    back = jckpt.load_pytree(jax.tree_util.tree_map(np.asarray, {
        "params": {"w": np.zeros((4, 3), np.float32), "layers": {"b": np.zeros((2, 3), np.float32)}},
        "opt_state": {"step": np.zeros((), np.int32)}, "step": 0}), tmp_path, 13)
    assert int(back["step"]) == 3


# ---------------------------------------------------------------- fault tolerance

def _step(state, batch):
    p = {k: v + 1.0 for k, v in state.params.items()}
    return RunState(p, state.opt_state, state.step), {"loss": torch.ones(())}


def test_recovery_from_injected_fault(tmp_path):
    ck = Checkpointer(tmp_path)
    boom = {"armed": True}

    def injector(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("synthetic node failure")

    state, report = run_with_recovery(
        _step, RunState({"w": torch.zeros(())}, {}, 0), lambda s: iter(lambda: {"x": 0}, None),
        num_steps=10, checkpointer=ck, checkpoint_every=2, fault_injector=injector)
    assert report["restarts"] == 1 and report["checkpoints"] >= 4
    assert state.step == 10
    assert float(state.params["w"]) == 10.0    # 6 from the checkpoint + 4 more steps


def test_exhausted_restarts_raise(tmp_path):
    def injector(step):
        raise RuntimeError("always failing")

    with pytest.raises(RuntimeError):
        run_with_recovery(_step, RunState({"w": torch.zeros(())}, {}, 0),
                          lambda s: iter(lambda: {"x": 0}, None), num_steps=4,
                          checkpointer=Checkpointer(tmp_path), max_restarts=2,
                          fault_injector=injector)


def test_straggler_flagging():
    pol = StragglerPolicy(threshold=2.0, warmup_steps=4)
    t = StepTimer()
    for _ in range(8):
        t.record(1.0)
    assert not pol.check(t, 1.5)
    assert pol.check(t, 5.0)
    assert pol.flagged == 1
