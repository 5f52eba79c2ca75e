"""The port's config arithmetic and abstract input specs against the
reference's (``repro.configs.base``, ``repro.launch.specs``).

Config counts: for all ten architectures and the four assigned shapes,
``param_count``, ``active_param_count``, ``model_flops_per_token`` (train,
prefill, decode), ``tokens_per_step`` and ``shape_applicable`` equal the
reference's exactly. The formulas leave out norms and biases and count the
unpadded vocabulary, so they differ from the numel of the parameter tree;
that gap is recorded per arch and is the reference's own gap.

Specs: leaf for leaf shapes, dtypes and sanitized PartitionSpecs equal the
reference's ``input_specs`` / ``cache_specs`` (qwen2.5-3b train_4k,
prefill_32k and decode_32k on a 1 x 1 mesh, in process), and all ten archs'
decode_32k inputs on a 2 x 2 mesh (the reference in a subprocess with 4
host devices, ``eval_shape`` only), with and without ``shard_kv_seq``. A
stacked leaf of the reference (leading ``L``) is one leaf a layer in the
port, with that entry dropped.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import ReplayMesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(jconfigs.ARCHS)
SHAPES = list(jconfigs.SHAPES)


def _cpu_mesh(shape):
    return ReplayMesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


# ---------------------------------------------------------------- configs

def test_registry_and_shapes_match():
    assert sorted(configs.ARCHS) == ARCHS
    assert sorted(configs.all_configs()) == sorted(jconfigs.all_configs())
    assert list(configs.SHAPES) == SHAPES
    for name, shape in configs.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(jconfigs.SHAPES[name])
    assert all(c.shard_kv_seq is False for c in configs.all_configs().values())


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_flops_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.block_params() == jcfg.block_params()
    assert cfg.active_block_params() == jcfg.active_block_params()
    for name in SHAPES:
        shape, jshape = configs.SHAPES[name], jconfigs.SHAPES[name]
        assert shape.tokens_per_step == jshape.tokens_per_step
        assert configs.shape_applicable(cfg, shape) == jconfigs.shape_applicable(jcfg, jshape)
        for training, decode in ((True, False), (False, False), (False, True)):
            assert (cfg.model_flops_per_token(shape.seq_len, training=training, decode=decode)
                    == jcfg.model_flops_per_token(jshape.seq_len, training=training,
                                                  decode=decode))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_gap_to_the_tree_is_the_references(arch):
    """``param_count`` leaves out norms, biases, the pad rows of the
    vocabulary and (SSM) D / dt_bias / A_log; the gap to the tree's numel
    is recorded, and it is the reference's gap for the same config."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    numel = M.param_count(M.Model(cfg, "meta"))
    jtree = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jnumel = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jtree))
    gap = numel - cfg.param_count()
    assert numel == jnumel
    assert gap == jnumel - jcfg.param_count()
    assert gap >= (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model


# ---------------------------------------------------------------- specs

def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _jleaf(tree, name):
    path = name.split(".")
    stacked = path[0] in ("layers", "encoder")
    if stacked:
        path = [path[0]] + path[2:]
    for key in path:
        tree = tree[key]
    return tree, stacked


def _same_leaf(t, jt, stacked=False, label=""):
    jshape, jspec = tuple(jt.shape), tuple(jt.sharding.spec)
    if stacked:
        jshape, jspec = jshape[1:], jspec[1:]
    assert tuple(t.shape) == jshape, label
    assert _dtype(t.dtype) == str(jt.dtype), label
    assert tuple(t.pspec) == jspec, label


def _same_params(tree, jtree, label):
    for name, t in tree.items():
        jt, stacked = _jleaf(jtree, name)
        _same_leaf(t, jt, stacked, f"{label}:{name}")


def _same_caches(caches, jcaches, label):
    assert len(caches) == len(jcaches)
    for i, (c, jc) in enumerate(zip(caches, jcaches)):
        assert c.keys() == jc.keys(), label
        for group in c:
            assert c[group].keys() == jc[group].keys(), label
            for k in c[group]:
                _same_leaf(c[group][k], jc[group][k], label=f"{label}:{i}.{group}.{k}")


@pytest.fixture(scope="module")
def mesh11():
    return _cpu_mesh((1, 1)), jax.make_mesh((1, 1), ("data", "model"),
                                            devices=jax.devices()[:1])


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_leaf_for_leaf_on_1x1(mesh11, shape_name):
    mesh, jmesh = mesh11
    cfg, jcfg = configs.get_config("qwen2.5-3b"), jconfigs.get_config("qwen2.5-3b")
    train = shape_name == "train_4k"
    out = SP.input_specs(cfg, configs.SHAPES[shape_name], mesh, adamw(1e-4) if train else None)
    jout = JSP.input_specs(jcfg, jconfigs.SHAPES[shape_name], jmesh,
                           jax_adamw(1e-4) if train else None)
    assert set(out) == set(jout)
    assert all(t.device.type == "meta" for t in out["params"].values())
    assert list(out["params"]) == [n for n, _ in M.Model(cfg, "meta").named_parameters()]
    _same_params(out["params"], jout["params"], "params")
    assert {n: t.pspec for n, t in out["params"].items()} == out["params_sharding"]
    if train:
        for k in ("mu", "nu"):
            _same_params(out["opt_state"][k], jout["opt_state"][k], k)
        _same_leaf(out["opt_state"]["step"], jout["opt_state"]["step"], label="step")
    if "batch" in out:
        _same_leaf(out["batch"]["tokens"], jout["batch"]["tokens"], label="tokens")
    if shape_name == "decode_32k":
        _same_leaf(out["tokens"], jout["tokens"], label="tokens")
        _same_leaf(out["pos"], jout["pos"], label="pos")
        _same_caches(out["caches"], jout["caches"], "caches")


def test_train_specs_need_the_optimizer(mesh11):
    with pytest.raises(ValueError, match="optimizer"):
        SP.input_specs(configs.get_config("qwen2.5-3b"), configs.SHAPES["train_4k"], mesh11[0])


_REFERENCE_DECODE_SPECS = r"""
import dataclasses, json, sys
import jax
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import specs as SP
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
out = {}
for kv_seq in (False, True):
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), shard_kv_seq=kv_seq)
        toks, pos, caches = SP.decode_input_specs(cfg, SHAPES["decode_32k"], mesh)
        leaves = {"tokens": toks, "pos": pos}
        for i, c in enumerate(caches):
            for g, d in c.items():
                for k, v in d.items():
                    leaves[f"{i}.{g}.{k}"] = v
        out[f"{arch}|{kv_seq}"] = {n: [list(v.shape), str(v.dtype), list(v.sharding.spec)]
                                   for n, v in leaves.items()}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference_decode_specs():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(ROOT / "src")
    run = subprocess.run([sys.executable, "-c", _REFERENCE_DECODE_SPECS], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout)


def _norm(spec):
    return [list(e) if isinstance(e, (list, tuple)) else e for e in spec]


@pytest.mark.parametrize("kv_seq", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_specs_on_2x2_equal_the_reference(reference_decode_specs, arch, kv_seq):
    cfg = dataclasses.replace(configs.get_config(arch), shard_kv_seq=kv_seq)
    toks, pos, caches = SP.decode_input_specs(cfg, configs.SHAPES["decode_32k"],
                                              _cpu_mesh((2, 2)))
    leaves = {"tokens": toks, "pos": pos}
    for i, c in enumerate(caches):
        for g, d in c.items():
            for k, v in d.items():
                leaves[f"{i}.{g}.{k}"] = v
    want = reference_decode_specs[f"{arch}|{kv_seq}"]
    assert set(leaves) == set(want)
    for name, t in leaves.items():
        shape, dtype, spec = want[name]
        assert [list(t.shape), _dtype(t.dtype), _norm(t.pspec)] == [shape, dtype, _norm(spec)], name
    if arch == "hymba-1.5b":
        assert caches[0]["attn"]["k"].shape[1] == 1024     # ring buffer == window
        # 5 kv heads do not split 2 ways: shard_kv_seq shards the length instead
        want_k = ("data", "model", None, None) if kv_seq else ("data", None, None, None)
        assert tuple(caches[0]["attn"]["k"].pspec) == want_k
