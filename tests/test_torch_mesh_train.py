"""Training under a (data, model) mesh: ``make_train_step(cfg, opt, mesh=...)``.

The reference ``jit``s its unsharded step with ``in_shardings`` and GSPMD
partitions it; its own sharded runs fail with the installed jax
(``test_distributed.py::test_train_step_on_2x2_mesh`` and
``test_sharding.py::TestSmallMeshLowering::test_train_step_lowers_and_runs``
raise ``ShardingTypeError`` on the embedding gather). So the port's
sharded step is held to JAX's UNSHARDED step on the same weights (the
reference's case: reduced glm4-9b, a 2 x 2 mesh, tokens ``full((4, 16),
3)``) at ``test_torch_training.py``'s tolerance, to the port's unsharded
step at 2e-5, and bitwise to the same step run chunk by chunk with the same
summation order: one controller runs each batch shard's chunk as the
unsharded step would at that chunk (ROADMAP C: a shard's call is the
unsharded call). A 1 x 1 mesh is bitwise the step without one.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import ReplayMesh, make_small_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import partition as P_  # noqa: E402
from repro_torch.sharding import replay as R  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training.step import sharded_loss_and_grads  # noqa: E402

TOL = 1e-4                      # test_torch_training.py's loss tolerance
P_ATOL, P_RTOL = 1e-3, 5e-3     # and its params / moments tolerance
SHARD_TOL = 2e-5                # sharded vs unsharded within the port (f32)
KEY = jax.random.PRNGKey(0)
GLM = dict(d_model=64, num_heads=4, head_dim=16)


@pytest.fixture(autouse=True)
def _init_independent_of_the_process(monkeypatch):
    """ROADMAP C1: the reference's init keys fold Python's per-process
    ``hash`` of each name; CRC-32 makes KEY alone fix the weights."""
    monkeypatch.setattr(JL, "hash", lambda s: zlib.crc32(str(s).encode()), raising=False)


def _pair(arch, **kw):
    jcfg = jax_reduced(jax_get_config(arch), **kw)
    cfg = reduced(get_config(arch), **kw)
    jparams = JM.init_params(jcfg, KEY)
    params = M.params_of(M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                           cfg, "cpu"))
    return jcfg, jparams, cfg, params


def _mesh(n_data, n_model):
    return make_small_mesh(n_data, n_model, device="cpu")


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _batches(cfg, n, B=4, S=16):
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
    return [{"tokens": torch.from_numpy(ds.batch(i)["tokens"])} for i in range(n)]


def _run(cfg, params, batches, mesh, lr=1e-2):
    opt = adamw(lr)
    params = _clone(params)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh=mesh)
    metrics = []
    for b in batches:
        params, state, m = step(params, state, b)
        metrics.append(m)
    return params, state, metrics


def _chunk_by_chunk(cfg, params, batches, n_shards, lr=1e-2):
    """The step written out by hand: each contiguous chunk through the
    unsharded loss and gradients, weighted by its token share, summed in
    shard order, then AdamW once."""
    opt = adamw(lr)
    params = _clone(params)
    state = opt.init(params)
    metrics = []
    for b in batches:
        B = b["tokens"].shape[0]
        rows = [{k: v[i * B // n_shards:(i + 1) * B // n_shards] for k, v in b.items()}
                for i in range(n_shards)]
        counts = [M.loss_labels(r)[1].sum() for r in rows]
        total = torch.clamp(torch.stack(counts).sum(), min=1.0)
        grads, sums = {}, {}
        for r, c in zip(rows, counts):
            w = c / total
            diff = {k: v.detach().requires_grad_() for k, v in params.items()}
            loss, m = M.loss_fn(M.bind(cfg, diff), cfg, r)
            g = torch.autograd.grad(loss * w, list(diff.values()))
            for k, v in zip(diff, g):
                grads[k] = v if k not in grads else grads[k] + v
            for k, v in m.items():
                v = v.detach() if k == "tokens" else v.detach() * w
                sums[k] = v if k not in sums else sums[k] + v
        sums.update(opt.update_(grads, state, params))
        metrics.append(sums)
    return params, state, metrics


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def _close_params(got, jtree, cfg, atol=P_ATOL, rtol=P_RTOL):
    want = M.flatten_jax(jax.tree_util.tree_map(np.asarray, jtree), cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def test_reference_case_on_2x2_against_jax_unsharded_step():
    jcfg, jparams, cfg, params = _pair("glm4-9b", **GLM)
    jopt = jax_adamw(1e-3)
    toks = np.full((4, 16), 3, np.int32)
    js = jopt.init(jparams)
    jp2, js2, jm = jax.jit(jax_train_step(jcfg, jopt))(jparams, js, {"tokens": jnp.asarray(toks)})
    p2, s2, ms = _run(cfg, params, [{"tokens": torch.from_numpy(toks)}], _mesh(2, 2), lr=1e-3)
    assert np.isfinite(float(ms[0]["loss"]))
    np.testing.assert_allclose(float(ms[0]["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(ms[0]["grad_norm"]), float(jm["grad_norm"]), rtol=TOL)
    _close_params(p2, jp2, cfg)
    _close_params(s2["mu"], js2["mu"], cfg)
    _close_params(s2["nu"], js2["nu"], cfg)
    assert int(s2["step"]) == int(js2["step"]) == 1


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (2, 1)])
@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2.5-3b", "mamba2-370m"])
def test_sharded_against_unsharded_and_bitwise_chunk_by_chunk(arch, mesh_shape):
    """At lr 1e-4: AdamW moves each weight by about +-lr a step, so an entry
    whose gradient is near 0 (and may take either sign under another
    summation order) moves at most 3 lr over the steps, inside P_ATOL."""
    _, _, cfg, params = _pair(arch)
    batches = _batches(cfg, 3)
    p_sh, s_sh, m_sh = _run(cfg, params, batches, _mesh(*mesh_shape), lr=1e-4)
    p_un, s_un, m_un = _run(cfg, params, batches, None, lr=1e-4)
    p_cc, s_cc, m_cc = _chunk_by_chunk(cfg, params, batches, mesh_shape[0], lr=1e-4)
    for a, b, c in zip(m_sh, m_un, m_cc):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=SHARD_TOL, err_msg=k)
        assert float(a["tokens"]) == float(b["tokens"])
        _assert_trees_equal({k: a[k] for k in c}, c)
    # after three AdamW steps the params and moments agree at the
    # optimizer's tolerance (its sqrt denominator magnifies last bits of
    # near-zero gradients), and are bitwise the chunk-by-chunk run's
    for tree_sh, tree_un in ((p_sh, p_un), (s_sh["mu"], s_un["mu"]), (s_sh["nu"], s_un["nu"])):
        for k in params:
            torch.testing.assert_close(tree_sh[k], tree_un[k], atol=P_ATOL, rtol=P_RTOL)
    _assert_trees_equal(p_sh, p_cc)
    _assert_trees_equal(s_sh, s_cc)
    # the first step's gradients at the f32 tolerance
    m1, g1 = sharded_loss_and_grads(cfg, params, batches[0], _mesh(*mesh_shape))
    diff = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = M.loss_fn(M.bind(cfg, diff), cfg, batches[0])
    for k, g in zip(diff, torch.autograd.grad(loss, list(diff.values()))):
        torch.testing.assert_close(g1[k], g, atol=SHARD_TOL, rtol=SHARD_TOL)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "hymba-1.5b"])
def test_one_by_one_mesh_is_the_step_without_one(arch):
    _, _, cfg, params = _pair(arch)
    batches = _batches(cfg, 2)
    p1, s1, m1 = _run(cfg, params, batches, _mesh(1, 1))
    p0, s0, m0 = _run(cfg, params, batches, None)
    _assert_trees_equal(p1, p0)
    _assert_trees_equal(s1, s0)
    for a, b in zip(m1, m0):
        _assert_trees_equal(a, b)


def test_loss_mask_weights_chunks_by_their_tokens():
    """Chunks of unequal token counts: the sharded loss is still the whole
    batch's mean over tokens (each chunk weighted by its share)."""
    _, _, cfg, params = _pair("qwen2.5-3b")
    b = _batches(cfg, 1)[0]
    mask = torch.ones_like(b["tokens"], dtype=torch.float32)
    mask[:2, 5:] = 0.0                      # shard 0 keeps far fewer tokens
    b = {**b, "loss_mask": mask}
    m_sh, g_sh = sharded_loss_and_grads(cfg, params, b, _mesh(2, 1))
    diff = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, m = M.loss_fn(M.bind(cfg, diff), cfg, b)
    g = dict(zip(diff, torch.autograd.grad(loss, list(diff.values()))))
    np.testing.assert_allclose(float(m_sh["ce"]), float(m["ce"].detach()), rtol=SHARD_TOL)
    assert float(m_sh["tokens"]) == float(m["tokens"])
    for k in g:
        torch.testing.assert_close(g_sh[k], g[k], atol=SHARD_TOL, rtol=SHARD_TOL)


def test_moe_experts_over_model_with_shard_map():
    """Reduced qwen3-moe with ``moe_impl="shard_map"`` on a 2 x 2 mesh: each
    batch chunk's experts run over its row's two model positions (drop-free
    capacity): CE within 2e-5 of the unsharded global dispatch, the aux
    loss the token-weighted mean of each chunk's own (as the reference's
    ``pmean`` over data shards), and the step bitwise the chunks run one by
    one under the row's mesh."""
    _, _, cfg, params = _pair("qwen3-moe-30b-a3b")
    cfg_sm = dataclasses.replace(cfg, moe_impl="shard_map")
    mesh = _mesh(2, 2)
    b = _batches(cfg, 1)[0]
    m_sh, g_sh = sharded_loss_and_grads(cfg_sm, params, b, mesh)
    with torch.no_grad():
        _, m_un = M.loss_fn(M.bind(cfg, params), cfg, b)
        auxes = [M.loss_fn(M.bind(cfg, params), cfg, {"tokens": b["tokens"][i:i + 2]})[1]["aux"]
                 for i in (0, 2)]
    np.testing.assert_allclose(float(m_sh["ce"]), float(m_un["ce"]), rtol=SHARD_TOL)
    np.testing.assert_allclose(float(m_sh["aux"]), float(sum(auxes) / 2), rtol=SHARD_TOL)
    # by hand: each chunk under its row's mesh, weighted, summed in order
    grads = {}
    for coords, (dev, a, z) in zip(R.shard_coords(mesh), R.lane_chunks(4, mesh)):
        with P_.use_mesh(mesh.select(coords)):
            diff = {k: v.detach().requires_grad_() for k, v in params.items()}
            loss, _ = M.loss_fn(M.bind(cfg_sm, diff), cfg_sm, {"tokens": b["tokens"][a:z]})
            w = torch.tensor(0.5)
            for k, v in zip(diff, torch.autograd.grad(loss * w, list(diff.values()))):
                grads[k] = v if k not in grads else grads[k] + v
    _assert_trees_equal(g_sh, grads)


def test_mesh_row_selection_names_global_positions():
    mesh = _mesh(2, 2)
    row = mesh.select({"data": 1})
    assert row.shape == {"data": 1, "model": 2}
    assert [row.index_at({"model": m}) for m in range(2)] == [2, 3]
    assert R.shard_coords(mesh) == [{"data": 0}, {"data": 1}]


def test_train_step_lowers_and_runs_on_a_1x1_mesh():
    """The port's counterpart of ``test_sharding.py::TestSmallMeshLowering::
    test_train_step_lowers_and_runs``: params placed by the partition rules
    on a 1 x 1 mesh, one step of the mesh-aware step, a finite loss."""
    cfg = reduced(get_config("qwen2.5-3b"))
    mesh = _mesh(1, 1)
    with P_.use_mesh(mesh):
        params = M.params_of(M.init_params(cfg, torch.Generator().manual_seed(0)))
        placed = P_.param_shardings(params, mesh)
        params = {k: v[0] for k, v in placed.items()}
        opt = adamw(1e-3)
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh=mesh)
        tokens = torch.zeros((2, 16), dtype=torch.int32) + 3
        p2, s2, m = step(params, state, {"tokens": tokens})
    assert np.isfinite(float(m["loss"])) and int(s2["step"]) == 1


def test_batch_that_does_not_split_raises():
    _, _, cfg, params = _pair("qwen2.5-3b")
    opt = adamw(1e-3)
    step = make_train_step(cfg, opt, mesh=_mesh(4, 1))
    with pytest.raises(ValueError, match="do not split"):
        step(_clone(params), opt.init(params), {"tokens": torch.zeros((2, 8), dtype=torch.int32)})


def test_position_parts_name_the_batch_shards():
    """Each batch chunk runs as a part at its shard's position (the
    dry-run attributes work by it); outside every part, position 0."""
    _, _, cfg, params = _pair("qwen2.5-3b")
    seen = []
    real = M.loss_fn

    def spy(p, c, b):
        seen.append(R.current_part())
        return real(p, c, b)

    mesh = ReplayMesh((2, 2), ("data", "model"), ["cpu"] * 4)
    M.loss_fn, orig = spy, M.loss_fn
    try:
        sharded_loss_and_grads(cfg, params, _batches(cfg, 1)[0], mesh)
    finally:
        M.loss_fn = orig
    assert seen == [(0, 1, "all-gather", "all-reduce"), (2, 1, "all-gather", "all-reduce")]
    assert R.current_part() == (0, 0, None, None)
