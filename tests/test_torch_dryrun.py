"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

The reference's test (``tests/test_distributed.py::
test_dryrun_single_cell_small_mesh``) lowers three cells on a 2 x 2 mesh:
qwen2.5-3b train_4k (its cost extrapolated: here ``"exact"``, every layer
counted), mamba2-370m long_500k (a decode cell) and qwen2.5-3b long_500k
(skipped). The full-size train cell takes minutes of fake-tensor ops on the
CPU, so it carries the ``slow`` marker as the reference's test does; a
reduced-config train cell runs in tier 1. Every record has the reference's
keys, and ``model_flops_global`` is the reference's config arithmetic for
every cell. The per-position counts add up to ``FlopCounterMode``'s total,
which equals the count of one real step at a reduced size; the bytes moved
between positions follow the port's plan; no real storage is allocated.
"""
import json
import resource

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduced, register  # noqa: E402
from repro_torch.core.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import ReplayMesh, make_production_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

# the reference's record keys (src/repro/launch/dryrun.py, lower_cell)
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "chips", "opts", "timings", "cost_mode",
               "memory", "collectives", "roofline", "params", "active_params"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "hlo_flops_per_device", "hlo_bytes_per_device", "link_bytes_per_device",
                 "model_flops_global", "model_flops_per_device", "useful_flop_ratio"}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _meta_mesh(shape, names=("data", "model")):
    return ReplayMesh(shape, names, ["meta"] * int(np.prod(shape)))


def _reference_model_flops(arch, shape_name):
    jcfg, jshape = jconfigs.get_config(arch), jconfigs.SHAPES[shape_name]
    return (jcfg.model_flops_per_token(jshape.seq_len, training=jshape.kind == "train",
                                       decode=jshape.kind == "decode")
            * jshape.tokens_per_step)


def _reduced(arch, **kw):
    tag = "".join(f"-{k}={v}" for k, v in sorted(kw.items()))
    cfg = reduced(get_config(arch), name=f"{arch}-dryrun{tag}", **kw)
    register(cfg)
    return cfg


def _check_record(r, n_chips):
    assert set(r) == RECORD_KEYS
    assert set(r["roofline"]) == ROOFLINE_KEYS
    assert r["cost_mode"] == "exact" and r["chips"] == n_chips
    assert set(COLLECTIVES) <= set(r["collectives"]) and "link_bytes" in r["collectives"]
    assert r["roofline"]["hlo_flops_per_device"] > 0
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    json.dumps(r)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("shape_name", list(jconfigs.SHAPES))
def test_model_flops_are_the_reference_arithmetic(arch, shape_name):
    cfg, shape = get_config(arch), configs.SHAPES[shape_name]
    assert D._model_flops(cfg, shape) == _reference_model_flops(arch, shape_name)


@pytest.mark.slow
def test_reference_cells_full_size():
    """The reference's three cells at full size on a 2 x 2 mesh (~40 s of
    fake-tensor ops for the train cell on the CPU)."""
    mesh = _meta_mesh((2, 2))
    r = D.lower_cell("qwen2.5-3b", "train_4k", mesh=mesh, save=False)
    _check_record(r, 4)
    assert r["roofline"]["model_flops_global"] == _reference_model_flops("qwen2.5-3b",
                                                                        "train_4k")
    assert r["collectives"]["all-reduce"]["bytes"] > 0


def test_reference_decode_and_skipped_cells():
    mesh = _meta_mesh((2, 2))
    r2 = D.lower_cell("mamba2-370m", "long_500k", mesh=mesh, save=False)
    assert r2["kind"] == "decode"
    _check_record(r2, 4)
    assert r2["roofline"]["model_flops_global"] == _reference_model_flops("mamba2-370m",
                                                                         "long_500k")
    r3 = D.lower_cell("qwen2.5-3b", "long_500k", mesh=mesh, save=False)
    assert "skipped" in r3


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m",
                                  "whisper-small", "hymba-1.5b"])
def test_reduced_cells_count_per_position(arch, kind):
    """Reduced configs on a 2 x 2 meta mesh: the record's keys, and the
    per-position FLOPs add up to FlopCounterMode's total (both shards do
    the same work, so each holds half)."""
    cfg = _reduced(arch)
    r = D.lower_cell(cfg.name, ShapeConfig(kind, 32, 4, kind), mesh=_meta_mesh((2, 2)),
                     save=False)
    _check_record(r, 4)
    assert r["roofline"]["hlo_flops_per_device"] * 2 == r["collectives"]["flops_global"]
    assert r["memory"]["position"] == 0
    assert r["memory"]["argument_size_in_bytes"] > r["memory"][
        "reference_layout_argument_size_in_bytes"]
    moved = r["collectives"]["all-gather"]["bytes"]
    assert moved > 0
    if kind == "train":
        params = sum(t.numel() * t.element_size()
                     for t in M.Model(cfg, "meta").parameters())
        rows = sum(t.numel() * t.element_size() for t in SP.train_batch_specs(
            cfg, ShapeConfig(kind, 32, 4, kind), _meta_mesh((2, 2))).values()) // 2
        # shard 1 reads the params and its rows from position 0, and sends
        # its gradients (and a few scalar metrics) back
        assert params + rows <= moved < params + rows + 64
        assert params <= r["collectives"]["all-reduce"]["bytes"] < params + 64


def test_flops_and_arguments_equal_one_real_step():
    """The dry-run's count of a train cell equals FlopCounterMode's count
    of one real step of the same cell on the CPU (2 x 2 host mesh), and its
    per-position argument bytes equal those the real step's tensors take."""
    cfg = _reduced("qwen2.5-3b")
    shape = ShapeConfig("t", 32, 4, "train")
    r = D.lower_cell(cfg.name, shape, mesh=_meta_mesh((2, 2)), save=False)
    mesh = ReplayMesh((2, 2), ("data", "model"), ["cpu"] * 4)
    params = M.params_of(M.init_params(cfg, torch.Generator().manual_seed(0)))
    opt = adamw(1e-4)
    state = opt.init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32)}
    with FlopCounterMode(display=False) as counter:
        make_train_step(cfg, opt, mesh=mesh)(params, state, batch)
    assert counter.get_total_flops() == r["collectives"]["flops_global"]
    placed = D.argument_bytes({"params": params, "opt_state": state}, {"batch": batch}, mesh)
    assert placed[0] == r["memory"]["argument_size_in_bytes"]
    sp = SP.input_specs(cfg, shape, _meta_mesh((2, 2)), opt)
    assert placed == D.argument_bytes({"params": sp["params"], "opt_state": sp["opt_state"]},
                                      {"batch": sp["batch"]}, _meta_mesh((2, 2)))


def test_moe_expert_shards_move_all_to_all():
    cfg = _reduced("qwen3-moe-30b-a3b", moe_impl="shard_map")
    r = D.lower_cell(cfg.name, ShapeConfig("t", 32, 4, "train"), mesh=_meta_mesh((2, 2)),
                     save=False)
    assert r["collectives"]["all-to-all"]["bytes"] > 0
    assert r["roofline"]["hlo_flops_per_device"] * 2 < r["collectives"]["flops_global"]


def test_pipeline_edges_are_collective_permutes():
    """4 stages x 8 microbatches of (2, 16) f32: 3 edges a microbatch
    between stages and the last stage's output home, 128 bytes each (stage
    0 sits at position 0, where the input is), and each other stage's
    (16, 16) slice of the stacked params once."""
    S, M_ = 4, 8
    mesh = _meta_mesh((S,), ("stage",))
    counts = D.PositionCounts()
    W = torch.empty(S, 16, 16, device="meta")
    x = torch.empty(M_, 2, 16, device="meta")
    with counts:
        pipeline_apply(lambda w, h: torch.tanh(h @ w), W, x, mesh)
    assert counts.moved["collective-permute"] == {"count": S * M_ + S - 1,
                                                  "bytes": S * M_ * 128 + (S - 1) * 1024}
    assert all(counts.flops[s] == M_ * 2 * 2 * 16 * 16 for s in range(S))


def test_no_real_storage_at_full_size():
    """A full-size decode cell's arguments take ~90 GB; the run allocates
    none of it."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    r = D.lower_cell("qwen2.5-3b", "decode_32k", mesh=_meta_mesh((2, 2)), save=False)
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert r["memory"]["argument_size_in_bytes"] > 50e9
    assert grown_kib < 2 * 2**20          # under 2 GiB of host memory
    assert r["roofline"]["model_flops_global"] == _reference_model_flops("qwen2.5-3b",
                                                                        "decode_32k")


def test_overrides_and_cli_write_the_artifact(tmp_path, monkeypatch, capsys):
    cfg = D.apply_overrides(get_config("qwen2.5-3b"), {"shard_kv_seq": "true",
                                                       "attn_q_chunk": "4096"})
    assert cfg.shard_kv_seq is True and cfg.attn_q_chunk == 4096
    monkeypatch.setattr(D, "ART_DIR", tmp_path)
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False, device="meta": _meta_mesh((2, 2)))
    assert D.main(["--arch", "mamba2-370m", "--shape", "long_500k"]) == 0
    assert "[ok] mamba2-370m long_500k 2x2" in capsys.readouterr().out
    rec = json.loads((tmp_path / "mamba2-370m__long_500k__2x2.json").read_text())
    assert set(rec) == RECORD_KEYS
    assert D.main(["--arch", "qwen2.5-3b", "--shape", "long_500k"]) == 0
    assert "[skip] qwen2.5-3b long_500k" in capsys.readouterr().out


def test_production_meshes():
    mesh = make_production_mesh(device="meta")
    assert mesh.shape == {"data": 16, "model": 16} and len(mesh.devices) == 256
    pods = make_production_mesh(multi_pod=True, device="meta")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16} and len(pods.devices) == 512
    assert {d.type for d in pods.devices} == {"meta"}


def test_production_mesh_on_cards_needs_them():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 256:
        pytest.skip("256 cards are present")
    with pytest.raises(RuntimeError, match="distinct CUDA devices"):
        make_production_mesh()
