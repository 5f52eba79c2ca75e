"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once on
fake tensors (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's ``jit`` for 256 / 512 fake
host devices and reads XLA's analyses. The port has no compiler between
the program and the card, so "lower + compile" here is one run of the
cell's step under ``FakeTensorMode`` and ``FlopCounterMode``
(``core.costmodel.capture_cost_analysis``) on ``launch.specs.input_specs``,
over a production mesh of ``meta`` positions (``make_production_mesh(
device="meta")``): no storage is allocated and nothing launches. The step is
the port's own plan, one controller driving every position
(``sharding.replay.at_position`` names each position's part): a train cell
runs ``make_train_step(mesh=...)`` (one batch chunk a data shard, gradients
summed on position 0, AdamW once there); a prefill cell ``models.model.
prefill`` and a decode cell ``training.step.make_serve_step`` on each data
shard's rows, the results gathered on position 0. On ``meta`` tensors the
ops take their plain versions, whose products the counter sees.

For each cell a JSON record under ``dryrun_artifacts_torch/`` with the
reference's keys:

* ``memory``: the busiest position's argument and output bytes as the
  port's plan places them (position 0 holds the params and optimizer state
  whole), beside ``reference_layout_argument_size_in_bytes`` (each leaf's
  share under its sanitized spec, the reference's layout), and the peak of
  a live-bytes count over the fake run;
* ``collectives``: the bytes the single controller moves between distinct
  positions, under the reference's names (``all-gather`` for replicas and
  inputs, ``all-reduce`` for the gradient sum, ``all-to-all`` for expert
  dispatch, ``collective-permute`` for pipeline edges), with the
  reference's ``link_bytes`` rule (all-reduce bytes count twice);
* ``roofline``: the busiest position's FLOPs and bytes over the H100's
  peak rates (``launch.mesh``), its link bytes over NVLink's.

``cost_mode`` is ``"exact"`` for every cell: every layer is counted (the
reference extrapolates its train cells from two unrolled depths because
XLA counts a ``lax.scan`` body once).

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
          --shape train_4k [--multi-pod] [--all] [--opt key=val ...]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import sys
import time
import weakref
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..core.costmodel import capture_cost_analysis
from ..models import model as M
from ..optim.adamw import adamw as _adamw
from ..sharding import partition as P_
from ..sharding import replay as _shreplay
from ..training.step import make_serve_step, make_train_step
from . import specs as SP
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, ReplayMesh, make_production_mesh

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_artifacts_torch"

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class PositionCounts(TorchDispatchMode):
    """Per mesh position: FLOPs (``torch.utils.flop_counter``'s formulas),
    bytes accessed (each op's tensor inputs and outputs; views move
    nothing), live and peak bytes; and the bytes moved between positions.

    An op runs at the position of the innermost running
    ``replay.at_position`` part (position 0 outside every part). A tensor
    belongs to the position that made it (a view to its base's; the run's
    inputs to position 0). A tensor read at another position moves there
    once: its bytes count under the reader's inbound collective when the
    reader's part lies deeper than the maker's, else under the maker's
    outbound one, and they stay live at the reader while the tensor lives
    (the copy a distinct card would hold)."""

    def __init__(self):
        super().__init__()
        self.flops: dict[int, float] = collections.defaultdict(float)
        self.bytes: dict[int, float] = collections.defaultdict(float)
        self.live: dict[int, int] = collections.defaultdict(int)
        self.peak: dict[int, int] = collections.defaultdict(int)
        self.link: dict[int, int] = collections.defaultdict(int)
        self.moved = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
        # id(tensor) -> [position, depth, outbound, {reader: bytes held}];
        # a view shares its base's entry
        self._where: dict[int, list] = {}

    def _hold(self, pos: int, nbytes: int) -> None:
        self.live[pos] += nbytes
        self.peak[pos] = max(self.peak[pos], self.live[pos])

    def _free(self, key: int, rec: list, nbytes: int) -> None:
        if self._where.get(key) is rec:
            del self._where[key]
        if nbytes:          # the allocation dies (a view keeps its base alive)
            self.live[rec[0]] -= nbytes
            for pos, n in rec[3].items():
                self.live[pos] -= n

    def _own(self, t: torch.Tensor, rec: list, nbytes: int) -> None:
        self._where[id(t)] = rec
        weakref.finalize(t, self._free, id(t), rec, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pos, depth, inbound, outbound = _shreplay.current_part()
        inputs = _tensors((args, kwargs))
        for t in inputs:
            rec = self._where.get(id(t))
            if rec is None:         # an input of the run: position 0's
                rec = [0, 0, None, {}]
                self._own(t, rec, 0)
            if rec[0] != pos and pos not in rec[3]:
                kind = inbound if depth > rec[1] else rec[2]
                n = _nbytes(t)
                rec[3][pos] = n
                self._hold(pos, n)
                if kind is not None:
                    self.moved[kind]["count"] += 1
                    self.moved[kind]["bytes"] += n
                    factor = 2 if kind == "all-reduce" else 1
                    self.link[pos] += n * factor
                    self.link[rec[0]] += n * factor
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[pos] += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if not aliased:
            self.bytes[pos] += sum(map(_nbytes, inputs)) + sum(map(_nbytes, outs))
        for t in outs:
            if aliased and inputs:
                self._own(t, self._where[id(inputs[0])], 0)
            else:
                n = _nbytes(t)
                self._hold(pos, n)
                self._own(t, [pos, depth, outbound, {}], n)
        return out


def collective_stats(counts: PositionCounts) -> dict:
    """The bytes moved between positions under the reference's collective
    names (``count``: tensors moved; ``bytes``: their bytes), and
    ``link_bytes``, the busiest position's link bytes (the reference's rule:
    all-reduce bytes count twice; a move counts at both its ends)."""
    return {**{k: dict(v) for k, v in counts.moved.items()},
            "link_bytes": max(counts.link.values(), default=0)}


def apply_overrides(cfg: ModelConfig, opts: dict) -> ModelConfig:
    if not opts:
        return cfg
    coerced = {}
    for k, v in opts.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            coerced[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            coerced[k] = int(v)
        elif isinstance(cur, float):
            coerced[k] = float(v)
        else:
            coerced[k] = v
    return dataclasses.replace(cfg, **coerced)


def argument_bytes(args: Any, batch: Any, mesh: ReplayMesh) -> dict[int, int]:
    """Bytes a position holds as arguments under the port's plan: position
    0 holds ``args`` (params, optimizer state, caches) whole; each batch
    shard's position holds its rows of every tensor in ``batch`` (a batch
    that does not split over the shards stays whole on position 0). Real
    or meta tensors alike."""
    out = collections.defaultdict(int)
    out[0] += sum(map(_nbytes, _tensors(args)))
    rows = _tensors(batch)
    n = _shreplay.batch_axis_size(mesh)
    if rows and rows[0].shape[0] % n == 0:
        for coords in _shreplay.shard_coords(mesh):
            out[mesh.index_at(coords)] += sum(_nbytes(t) // n for t in rows)
    else:
        out[0] += sum(map(_nbytes, rows))
    return dict(out)


def reference_layout_bytes(tree: Any, mesh: ReplayMesh) -> int:
    """A position's bytes of ``tree`` (meta tensors carrying ``pspec``s)
    under the reference's sharded layout: each leaf's share under its
    sanitized spec."""
    total = 0
    for t in _tensors(tree):
        ways = 1
        for entry in t.pspec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                ways *= mesh.shape[a]
        total += _nbytes(t) // ways
    return total


def _row_call(fn: Callable, shared: Any, rows: Any, mesh: ReplayMesh) -> Any:
    """``fn(shared, rows)`` with ``rows`` (a tree of batch-major tensors)
    split into one contiguous chunk a batch shard, each chunk's call a part
    at its shard's position, the results concatenated on position 0. A
    batch that does not split over the shards runs whole on position 0."""
    B = _tensors(rows)[0].shape[0]
    n = _shreplay.batch_axis_size(mesh)
    if B % n:
        return fn(shared, rows)
    parts = []
    for coords, (device, a, b) in zip(_shreplay.shard_coords(mesh),
                                      _shreplay.lane_chunks(B, mesh)):
        with _shreplay.at_position(mesh, coords, "all-gather", "all-gather"), \
                P_.use_mesh(mesh.select(coords)):
            chunk = pytree.tree_map(lambda t, _a=a, _b=b: t[_a:_b], rows)
            parts.append(fn(_shreplay.replicate(shared, device),
                            _shreplay.replicate(chunk, device)))
    return _shreplay.gather_leading(parts, _tensors(rows)[0].device)


def _cell_call(cfg: ModelConfig, shape: ShapeConfig, mesh: ReplayMesh):
    """(specs, the cell's step as a function of its fake inputs, its
    arguments tree, its batch-major tree)."""
    if shape.kind == "train":
        optimizer = _adamw(1e-4)
        sp = SP.input_specs(cfg, shape, mesh, optimizer)
        step = make_train_step(cfg, optimizer, mesh=mesh)
        run = lambda f: step(f["params"], f["opt_state"], f["batch"])  # noqa: E731
        return sp, run, ("params", "opt_state"), ("batch",)
    sp = SP.input_specs(cfg, shape, mesh)
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return M.prefill(M.bind(cfg, params), cfg, batch, max_len=shape.seq_len)
        run = lambda f: _row_call(prefill_fn, f["params"], f["batch"], mesh)  # noqa: E731
        return sp, run, ("params",), ("batch",)
    serve = make_serve_step(cfg)

    def decode_fn(params, rows):
        return serve(M.bind(cfg, params), rows["tokens"], rows["pos"], rows["caches"])
    rows = ("tokens", "pos", "caches")
    run = lambda f: _row_call(decode_fn, f["params"], {k: f[k] for k in rows}, mesh)  # noqa: E731
    return sp, run, ("params",), rows


def _measure(cfg: ModelConfig, shape: ShapeConfig, mesh: ReplayMesh) -> dict:
    """One fake run of the cell's step; its per-position counts."""
    sp, run, arg_keys, row_keys = _cell_call(cfg, shape, mesh)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = pytree.tree_map(mode.from_tensor, {k: sp[k] for k in arg_keys + row_keys})
    counts, failed = PositionCounts(), []

    def observed(f):
        try:
            with counts:
                return run(f)
        except Exception as e:
            failed.append(e)
            raise

    t0 = time.perf_counter()
    cost = capture_cost_analysis(observed, fakes, mode)
    seconds = time.perf_counter() - t0
    if cost is None:
        raise RuntimeError(f"the {shape.name} step of {cfg.name} failed on fake "
                           "tensors") from (failed[0] if failed else None)
    args = {k: sp[k] for k in arg_keys}
    rows = {k: sp[k] for k in row_keys}
    placed = argument_bytes(args, rows, mesh)
    busiest = max(counts.flops, key=lambda p: (counts.flops[p], -p), default=0)
    # the outputs land on position 0
    out_bytes = cost["bytes accessed"] - sum(placed.values()) if busiest == 0 else 0
    return {"seconds": seconds, "cost": cost, "counts": counts, "busiest": busiest,
            "placed": placed,
            "memory": {
                "argument_size_in_bytes": placed.get(busiest, 0),
                "output_size_in_bytes": int(out_bytes),
                "temp_size_in_bytes": counts.peak[busiest],
                "peak_memory_in_bytes": placed.get(busiest, 0) + counts.peak[busiest],
                "reference_layout_argument_size_in_bytes": reference_layout_bytes(
                    {**args, **rows}, mesh),
                "position": busiest,
            }}


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    return (cfg.model_flops_per_token(shape.seq_len, training=shape.kind == "train",
                                      decode=shape.kind == "decode")
            * shape.tokens_per_step)


def lower_cell(arch: str, shape_name: str | ShapeConfig, *, multi_pod: bool = False,
               opts: dict | None = None, mesh: ReplayMesh | None = None,
               save: bool = True, rules=None) -> dict:
    """Dry-run one (arch, shape, mesh) cell: one fake run of its step.

    ``shape_name`` names one of :data:`SHAPES` or is a
    :class:`ShapeConfig` of its own; ``mesh`` defaults to the production
    mesh on ``meta`` positions. ``rules`` is a partition rule table for the
    specs and the MoE layer's mesh scope (``partition.DEFAULT_RULES``)."""
    opts = dict(opts or {})
    rules_tag = opts.pop("_rules", None)
    cfg = apply_overrides(get_config(arch), opts)
    if rules_tag is not None:
        opts["_rules"] = rules_tag   # keep in artifact tag/record
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    if shape.kind == "prefill":
        # larger q-chunks at 32k, as the reference (FLOPs and bytes are
        # chunking-invariant; only live temporaries grow)
        cfg = dataclasses.replace(cfg, attn_q_chunk=max(cfg.attn_q_chunk, 8192))
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": why}
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                              device="meta")
    n_chips = len(mesh.devices)
    mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)

    with P_.use_mesh(None, rules):      # the specs resolve by these rules
        m = _measure(cfg, shape, mesh)
    counts, p = m["counts"], m["busiest"]
    flops_total, bytes_total = counts.flops[p], counts.bytes[p]
    coll = collective_stats(counts)
    link_bytes = coll["link_bytes"]
    compute_s = flops_total / PEAK_FLOPS_BF16
    memory_s = bytes_total / HBM_BW
    collective_s = link_bytes / NVLINK_BW
    model_flops = _model_flops(cfg, shape)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "chips": n_chips,
        "opts": opts or {},
        "timings": {"full_unrolled": {"lower_s": round(m["seconds"], 2),
                                      "compile_s": 0.0}},
        "cost_mode": "exact",
        "memory": m["memory"],
        "collectives": {**coll, "flops_global": m["cost"]["flops"]},
        "roofline": {
            **{k: float(v) for k, v in terms.items()},
            "dominant": dominant,
            "hlo_flops_per_device": flops_total,
            "hlo_bytes_per_device": bytes_total,
            "link_bytes_per_device": link_bytes,
            "model_flops_global": model_flops,
            "model_flops_per_device": model_flops / n_chips,
            "useful_flop_ratio": (model_flops / n_chips) / flops_total
            if flops_total else None,
        },
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if save:
        ART_DIR.mkdir(exist_ok=True)
        tag = "" if not opts else "_opt-" + "-".join(
            f"{k}={v}" for k, v in sorted((opts or {}).items()))
        fname = ART_DIR / f"{arch}__{shape.name}__{mesh_name}{tag}.json"
        fname.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every applicable cell")
    ap.add_argument("--opt", action="append", default=[],
                    help="config override key=value (perf iterations)")
    ap.add_argument("--rules", choices=["default", "no_ssm_fsdp", "ssm_dp_only"],
                    default="default", help="partition rule table (perf iterations)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    rules = {"default": None,
             "no_ssm_fsdp": P_.NO_SSM_FSDP_RULES,
             "ssm_dp_only": P_.SSM_DP_ONLY_RULES}[args.rules]
    opts = dict(kv.split("=", 1) for kv in args.opt)
    if args.rules != "default":
        opts["_rules"] = args.rules  # lands in the artifact tag
    archs = list(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    pods = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    meshes = {mp: make_production_mesh(multi_pod=mp, device="meta") for mp in set(pods)}
    failures = 0
    for mp in pods:
        for arch in archs:
            for shape in shapes:
                mesh = meshes[mp]
                mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
                out = ART_DIR / f"{arch}__{shape}__{mesh_name}.json"
                if args.skip_existing and out.exists() and not opts:
                    print(f"[skip-existing] {arch} {shape} {mesh_name}")
                    continue
                try:
                    r = lower_cell(arch, shape, multi_pod=mp, opts=opts,
                                   mesh=mesh, rules=rules)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {arch} {shape} multi_pod={mp}: {type(e).__name__}: {e}",
                          flush=True)
                    continue
                if "skipped" in r:
                    print(f"[skip] {arch} {shape}: {r['skipped']}", flush=True)
                    continue
                rl = r["roofline"]
                tsum = sum(t["lower_s"] for t in r["timings"].values())
                print(f"[ok] {arch} {shape} {r['mesh']} "
                      f"fake run={tsum:.0f}s dom={rl['dominant']} "
                      f"comp={rl['compute_s']:.4f}s mem={rl['memory_s']:.4f}s "
                      f"coll={rl['collective_s']:.4f}s "
                      f"useful={rl['useful_flop_ratio'] and round(rl['useful_flop_ratio'], 3)}",
                      flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
