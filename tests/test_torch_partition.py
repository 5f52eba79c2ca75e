"""The port's logical-axis partition rules against ``repro.sharding.partition``.

For all ten configs at ``reduced()``, on a 2x2 and a 16x16 (data, model)
mesh, every parameter's ``param_pspecs`` entry and its ``sanitize_spec``
equal the reference's for the same leaf: the reference's leaves stack the
layers on a leading ``L`` axis (always replicated), which the port's
per-layer names (``layers.1.moe.experts.up.w``) do not have. The JAX side
runs on ``jax.sharding.AbstractMesh`` and on ``jax.eval_shape`` of the
parameters, so it needs no devices. Then the reference's scope, rule and
spec cases of ``tests/test_partition.py``, live on CPU meshes, and
``param_shardings``' placement.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import partition as JP_  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.mesh import ReplayMesh, make_replay_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding import partition as P_  # noqa: E402
from repro_torch.sharding.partition import PartitionSpec as P  # noqa: E402

ARCHS = sorted(JAX_ARCHS)


def _cpu_mesh(shape, names):
    n = 1
    for s in shape:
        n *= s
    return ReplayMesh(shape, names, ["cpu"] * n)


def _jax_leaf(tree, name):
    """The reference's leaf for a port name and whether its layers stack."""
    path = name.split(".")
    stacked = path[0] in ("layers", "encoder")
    if stacked:
        path = [path[0]] + path[2:]
    node = tree
    for key in path:
        node = node[key]
    return node, stacked


@pytest.fixture(scope="module")
def shapes():
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced(jax_get_config(arch))
        out[arch] = (reduced(get_config(arch)),
                     jax.eval_shape(lambda c=jcfg: JM.init_params(c, jax.random.PRNGKey(0))))
    return out


def test_ten_configs():
    assert len(ARCHS) == 10


@pytest.mark.parametrize("mesh_shape", [(2, 2), (16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_and_sanitize_equal_the_reference(shapes, arch, mesh_shape):
    cfg, jshapes = shapes[arch]
    names = ("data", "model")
    mesh, jmesh = _cpu_mesh(mesh_shape, names), jax.sharding.AbstractMesh(mesh_shape, names)
    jspecs = JP_.param_pspecs(jshapes, jmesh)
    leaves = {n: p for n, p in M._skeleton(cfg).named_parameters()}
    specs = P_.param_pspecs(leaves, mesh)
    assert set(specs) == set(leaves)
    for name, prm in leaves.items():
        jspec, stacked = _jax_leaf(jspecs, name)
        jshape = _jax_leaf(jshapes, name)[0].shape
        want, want_san = tuple(jspec), tuple(JP_.sanitize_spec(jshape, jspec, jmesh))
        if stacked:
            assert want[0] is None and want_san[0] is None, name
            want, want_san = want[1:], want_san[1:]
        assert tuple(specs[name]) == want, name
        assert tuple(P_.sanitize_spec(tuple(prm.shape), specs[name], mesh)) == want_san, name


def test_logical_axes_match_reference_on_synthetic_paths():
    for names, ndim in [(("experts", "up", "w"), 3), (("experts", "down", "w"), 4),
                        (("experts", "bias", "w"), 2), (("moe", "router", "w"), 2),
                        (("ssm", "A_log"), 1), (("final_norm", "scale"), 1),
                        (("embed", "table"), 2), (("x_proj", "w"), 3)]:
        assert P_.logical_axes_for_path(names, ndim) == JP_.logical_axes_for_path(names, ndim)


def test_rule_tables_equal_the_reference():
    assert P_.DEFAULT_RULES == JP_.DEFAULT_RULES
    assert P_.NO_SSM_FSDP_RULES == JP_.NO_SSM_FSDP_RULES
    assert P_.SSM_DP_ONLY_RULES == JP_.SSM_DP_ONLY_RULES


# ---------------------------------------------------------------- sanitize_spec

class TestSanitizeSpec:
    def test_drops_axis_on_non_divisible_dim(self):
        mesh = make_replay_mesh(2, device="cpu")
        assert P_.sanitize_spec((7, 64), P("data", None), mesh) == P(None, None)
        assert P_.sanitize_spec((8, 64), P("data", None), mesh) == P("data", None)

    def test_per_dim_independent(self):
        mesh = make_replay_mesh(2, device="cpu")
        assert P_.sanitize_spec((7, 8), P(None, "data"), mesh) == P(None, "data")

    def test_tuple_entry_uses_product_of_axis_sizes(self):
        mesh = _cpu_mesh((2, 2), ("data", "model"))
        assert P_.sanitize_spec((6,), P(("data", "model")), mesh) == P(None)
        assert P_.sanitize_spec((8,), P(("data", "model")), mesh) == P(("data", "model"))

    def test_short_spec_extends_with_replicated_dims(self):
        mesh = make_replay_mesh(2, device="cpu")
        assert P_.sanitize_spec((8, 3, 5), P("data"), mesh) == P("data", None, None)

    def test_size_one_axes_always_fit(self):
        mesh = _cpu_mesh((1, 1), ("data", "model"))
        assert P_.sanitize_spec((7, 13), P("data", "model"), mesh) == P("data", "model")

    def test_equals_the_reference(self):
        mesh, jmesh = _cpu_mesh((2, 4), ("data", "model")), \
            jax.sharding.AbstractMesh((2, 4), ("data", "model"))
        for shape, spec in [((6, 8), ("data", "model")), ((3, 12), ("model", "data")),
                            ((16,), (("data", "model"),)), ((5, 7, 9), (None, "data"))]:
            assert tuple(P_.sanitize_spec(shape, P(*spec), mesh)) == \
                tuple(JP_.sanitize_spec(shape, JP(*spec), jmesh))


# ---------------------------------------------------------------- specs on repo configs

class TestParamSpecsOnRepoConfigs:
    @pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m"])
    def test_specs_well_formed_for_family(self, arch):
        mesh = _cpu_mesh((1, 1), ("data", "model"))
        cfg = reduced(get_config(arch))
        model = M._skeleton(cfg)
        leaves = dict(model.named_parameters())
        for name, spec in P_.param_pspecs(model, mesh).items():
            assert len(spec) <= leaves[name].dim(), (name, spec)
            flat = [a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            assert set(flat) <= set(mesh.axis_names) and len(flat) == len(set(flat))

    def test_dense_spot_checks(self):
        mesh = _cpu_mesh((1, 1), ("data", "model"))
        specs = P_.param_pspecs(M._skeleton(reduced(get_config("qwen2.5-3b"))), mesh)
        assert specs["embed.table"] == P("model", "data")
        assert all(e is None for k, s in specs.items() if k.startswith("final_norm")
                   for e in s)

    def test_batch_pspec_shapes(self):
        mesh = _cpu_mesh((1, 1), ("data", "model"))
        assert P_.batch_pspec(mesh) == P("data", None)
        assert P_.batch_pspec(mesh, extra=3) == P("data", None, None, None)
        assert P_.batch_pspec(None) == P(None, None)
        assert P_.batch_pspec(make_replay_mesh(2, device="cpu"), extra=0) == P("data")
        assert P_.batch_pspec(_cpu_mesh((1, 1), ("pod", "data"))) == P(("pod", "data"), None)

    def test_param_shardings_place_slices_and_share_replicas(self):
        """Each position's slice of each leaf by its sanitized spec: views of
        the leaf where the device is its own, replicated leaves the leaf
        itself (never copied), and the slices tile the leaf."""
        mesh = _cpu_mesh((2, 2), ("data", "model"))
        cfg = reduced(get_config("qwen3-moe-30b-a3b"))
        params = M.params_of(M.Model(cfg, "cpu"))
        g = torch.Generator().manual_seed(0)
        for x in params.values():
            x.copy_(torch.randn(x.shape, generator=g))
        shards = P_.param_shardings(params, mesh)
        specs = P_.param_pspecs(params, mesh)
        for name, x in params.items():
            parts = shards[name]
            assert len(parts) == 4
            spec = P_.sanitize_spec(tuple(x.shape), specs[name], mesh)
            if all(e is None for e in spec):
                assert all(p is x for p in parts), name
                continue
            assert all(p.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
                       for p in parts), name
            for i, p in enumerate(parts):
                coords = {"data": i // 2, "model": i % 2}
                want = x
                for dim, entry in enumerate(spec):
                    n = P_._axis_size(mesh, entry)
                    if n > 1:
                        size = x.shape[dim] // n
                        want = want.narrow(dim, P_.shard_index(mesh, entry, coords) * size,
                                           size)
                assert torch.equal(p, want), (name, i)
        up = shards["layers.0.moe.experts.up.w"]        # ("model", "data", None)
        assert up[0].shape == (cfg.num_experts // 2, cfg.d_model // 2, cfg.expert_d_ff)


# ---------------------------------------------------------------- use_mesh scope

class TestUseMeshScope:
    def test_nesting_restores_previous(self):
        m1 = _cpu_mesh((1,), ("data",))
        m2 = _cpu_mesh((1, 1), ("data", "model"))
        assert P_.active_mesh() is None
        with P_.use_mesh(m1):
            assert P_.active_mesh() is m1
            with P_.use_mesh(m2):
                assert P_.active_mesh() is m2
            assert P_.active_mesh() is m1
        assert P_.active_mesh() is None

    def test_restores_on_exception(self):
        with pytest.raises(RuntimeError):
            with P_.use_mesh(_cpu_mesh((1,), ("data",))):
                raise RuntimeError("boom")
        assert P_.active_mesh() is None

    def test_scope_rules_drive_resolution(self):
        mesh = _cpu_mesh((1, 1), ("data", "model"))
        with P_.use_mesh(mesh, rules={"batch": ("model",)}):
            assert P_.resolve_axis("batch") == "model"
        with P_.use_mesh(mesh):
            assert P_.resolve_axis("batch") == "data"
            assert P_.resolve_axis("no_such_axis") is None
            assert P_.resolve_axis("seq") is None

    def test_nested_scope_rules_restore(self):
        mesh = _cpu_mesh((1, 1), ("data", "model"))
        with P_.use_mesh(mesh, rules={"batch": ("model",)}):
            with P_.use_mesh(mesh):
                assert P_.resolve_axis("batch") == "data"
            assert P_.resolve_axis("batch") == "model"

    def test_scope_is_thread_local(self):
        import threading
        seen = {}
        with P_.use_mesh(_cpu_mesh((2,), ("data",))):
            t = threading.Thread(target=lambda: seen.update(mesh=P_.active_mesh()))
            t.start()
            t.join(timeout=10)
        assert seen == {"mesh": None}

    def test_constrain_is_the_identity(self):
        x = torch.ones(4, 3)
        with P_.use_mesh(make_replay_mesh(2, device="cpu")):
            assert P_.constrain(x, ("batch", None)) is x
        assert P_.constrain(x, ("batch", None)) is x
