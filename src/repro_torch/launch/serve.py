"""Serving driver: batched prefill + decode; single-stream, server or cluster.

Port of ``repro.launch.serve``. Runs on the CUDA card; ``--device cpu`` is
the only way onto the CPU, and with no card and no ``--device cpu`` it
raises.

``--arch`` is any of the reference's ten configs: dense ``qwen2.5-3b``,
``glm4-9b``, ``minicpm-2b`` and ``minitron-8b``; VLM ``chameleon-34b``;
MoE ``qwen3-moe-30b-a3b`` and ``llama4-scout-17b-a16e``; SSM
``mamba2-370m``; hybrid ``hymba-1.5b``; encoder-decoder ``whisper-small``,
whose prompts come with random frame embeddings (B, 1500, d) from the
run's seed (the conv frontend is a stub, as in the reference).

* **Single-stream** (default): one prompt batch, prefill, then a greedy
  decode loop.

      PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
          --batch 4 --prompt-len 64 --gen 32

* **Multi-tenant server** (``--server``): N tenants each own a decode-step
  TDG (same structure, same payload, private caches, shared params) and
  drive it from N threads through :class:`repro_torch.serving.RegionServer`,
  which batches concurrent steps continuously (``--request-level`` for the
  run-to-completion dispatcher) into one ``torch.func.vmap``-batched
  replay, each step replayed from a CUDA graph on the card. ``--tiers``
  and ``--tenant-rate`` set the tenants' QoS tiers and rate limits;
  ``--trace-out`` records the program's spans (``core.spans``) from the
  first prefill and writes them beside the per-step trace ring as JSON.

      PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
          --server --tenants 4

* **Distributed cluster** (``--cluster W``): the same N-tenant decode drive
  through :class:`repro_torch.serving.ClusterFrontend`, W worker *processes*
  each running a ``RegionServer`` behind the socket RPC layer, on the same
  device. Workers re-link the decode step by symbol from
  :func:`build_decode_registry`; params ship once per worker as pinned
  buffers; each step's request carries only tokens, positions and caches;
  tenants route sticky by structure. ``--cluster 0`` uses
  ``REPRO_CLUSTER_WORKERS``. ``--workers host:port,...`` attaches
  pre-started workers (``python -m repro_torch.serving.worker --bind ...
  --registry repro_torch.launch.serve:build_decode_registry
  --registry-kwargs '{...}' --device ...``), plus the literal ``local`` to
  also spawn here; ``--token`` (default ``$REPRO_RPC_TOKEN``) must match
  the workers' handshake token.

      PYTHONPATH=src python -m repro_torch.launch.serve --smoke --cluster 2 \\
          --device cpu --tenants 4 --gen 8

``--smoke`` runs the reduced config (2 layers, d_model 64). Params are
f32, so on one 80 GB card the largest configs need their depth cut:
``--layers 16`` for qwen3-moe-30b-a3b (122 GB at 48 layers), ``--layers
12`` for chameleon-34b (137 GB at 48) and ``--layers 4`` for
llama4-scout-17b-a16e (layer index 3 is its global-attention layer).
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import torch

from ..configs import ARCHS, get_config, reduced
from ..core import spans
from ..core.serialize import TaskFnRegistry
from ..kernels import flash_attention as _fa
from ..kernels import moe_gmm as _gmm
from ..kernels import rmsnorm as _rms
from ..kernels import ssd_scan as _ssd
from ..models import init_params, prefill
from ..models import model as _model
from ..training import make_serve_step


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise
    (``None``); a CUDA device with no card raises (``"cpu"`` is the only way
    onto the CPU). The launchers, the worker CLI, ``WorkerNode`` and
    ``ClusterFrontend`` all resolve their device here."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for device={str(device)!r}; pass "
                           f"--device cpu (device='cpu') to run on the CPU")
    return device


def build_config(arch: str = "qwen2.5-3b", smoke: bool = True, layers: int = 0,
                 param_dtype: str | None = None):
    """The model config the serve entry points run: ``arch``, reduced with
    ``smoke``, its depth cut to ``layers`` (0 = the config's) and its params
    in ``param_dtype`` (None = the config's)."""
    cfg = get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    return cfg


def build_decode_registry(arch: str = "qwen2.5-3b", smoke: bool = True,
                          device: str = "cuda", layers: int = 0,
                          param_dtype: str | None = None) -> TaskFnRegistry:
    """Payload symbol table for ``--cluster`` workers (and the frontend).

    A spawned worker cannot receive the decode-step closure over the wire;
    it re-links the TDG's ``"decode"`` symbol by importing this factory and
    rebuilding the step from the (deterministic) model config — the paper's
    compiler-emitted TDG referencing outlined functions by name. The step
    takes its params as a ``Model`` or as a name -> tensor mapping (the
    pinned params a worker holds, or an exported program's inputs), read
    through ``models.model.bind``. ``device`` is checked as the entry points
    check it: a CUDA device with no card raises.
    """
    resolve_device(device)
    cfg = build_config(arch, smoke, layers, param_dtype)
    step = make_serve_step(cfg)

    def decode(params, tokens, pos, caches):
        if not isinstance(params, _model.Model):
            params = _model.bind(cfg, params)
        return step(params, tokens, pos, caches)

    reg = TaskFnRegistry()
    reg.register("decode")(decode)
    return reg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int,
                 device: torch.device) -> dict:
    """A prefill batch from a CPU generator seeded ``seed``: ``tokens``,
    random ids in [2, vocab), and for encdec ``frames`` (batch, encoder_seq,
    d_model), f32 normals (the stub frontend's frame embeddings)."""
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(2, cfg.vocab_size, (batch, prompt_len), generator=g,
                                   dtype=torch.int32).to(device)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                    generator=g).to(device)
    return out


def _print_kernels() -> None:
    print(f"kernels: rmsnorm {_rms.launches} launches, flash_attention "
          f"{_fa.launches}, grouped_matmul {_gmm.launches}, ssd_intra_chunk "
          f"{_ssd.launches}")


def _run_single_stream(args, cfg, params, device) -> int:
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed + 1, device)
    max_len = args.prompt_len + args.gen
    t0 = time.time()
    logits, caches, pos = prefill(params, cfg, batch, max_len=max_len)
    _sync(device)
    t_prefill = time.time() - t0

    serve_step = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    outs = [tok]
    t0 = time.time()
    for _ in range(args.gen - 1):
        tok, caches = serve_step(params, tok[:, None], pos, caches)
        pos = pos + 1
        outs.append(tok)
    _sync(device)
    t_decode = time.time() - t0
    gen = torch.stack(outs, dim=1)
    tput = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"prefill: {t_prefill*1e3:.1f} ms for {args.batch}x{args.prompt_len}")
    print(f"decode:  {t_decode*1e3:.1f} ms for {args.gen-1} steps "
          f"({tput:.1f} tok/s)")
    print("sample token ids:", gen[0, :16].tolist())
    _print_kernels()
    return 0


def _tenant_tiers(args) -> list[int]:
    """Per-tenant QoS tiers from ``--tiers`` ("1" or "0,1,...", cycled)."""
    if not args.tiers:
        return [0] * args.tenants
    cycle = [max(0, int(t)) for t in str(args.tiers).split(",") if t.strip()]
    return [cycle[i % len(cycle)] for i in range(args.tenants)]


def _print_tier_latency(tiers_summary) -> None:
    for tier in sorted(tiers_summary or {}, key=int):
        s = tiers_summary[tier]
        print(f"tier {tier}: n {s['count']}  p50 {s['p50_s']*1e3:.2f} ms  "
              f"p99 {s['p99_s']*1e3:.2f} ms")


def _run_server(args, cfg, params, device) -> int:
    from ..core import TDG
    from ..serving import RegionServer

    decode = make_serve_step(cfg)   # ONE payload object shared by all tenants
    max_len = args.prompt_len + args.gen

    # Per-tenant prefill: private prompt, caches and positions; params are
    # shared (same object), so the server broadcasts rather than stacks them.
    states = []
    t0 = time.time()
    for i in range(args.tenants):
        batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed + 1 + i,
                             device)
        logits, caches, pos = prefill(params, cfg, batch, max_len=max_len)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        states.append({"tok": tok, "pos": pos, "caches": caches, "out": [tok]})
    _sync(device)
    t_prefill = time.time() - t0

    server = RegionServer(max_batch=args.max_batch or args.tenants,
                          max_wait_ms=args.max_wait_ms, name="decode-server",
                          continuous=False if args.request_level else None)
    tiers = _tenant_tiers(args)
    for i in range(args.tenants):
        # One decode-step region per tenant, structurally identical across
        # tenants (same payload object), so they intern to one entry.
        tdg = TDG(f"decode[{i}]")
        tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                     outs=["next", "caches"], name="decode")
        server.register_tenant(f"tenant{i}", tdg, outputs=("next", "caches"),
                               tier=tiers[i], rate=args.tenant_rate or None)

    errors: list[BaseException] = []

    def tenant_loop(i: int) -> None:
        try:
            st = states[i]
            for _ in range(args.gen - 1):
                out = server.serve(f"tenant{i}", {
                    "params": params, "tokens": st["tok"][:, None],
                    "pos": st["pos"], "caches": st["caches"]})
                st["tok"] = out["next"]
                st["caches"] = out["caches"]
                st["pos"] = st["pos"] + 1
                st["out"].append(st["tok"])
        except BaseException as e:   # surface thread failures, don't exit 0
            errors.append(e)

    threads = [threading.Thread(target=tenant_loop, args=(i,))
               for i in range(args.tenants)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_decode = time.time() - t0
    server.close()
    if errors:
        raise errors[0]

    stats = server.stats()
    m = stats["metrics"]
    toks = args.tenants * args.batch * (args.gen - 1)
    print(f"prefill: {t_prefill*1e3:.1f} ms for {args.tenants} tenants "
          f"x {args.batch}x{args.prompt_len}")
    print(f"decode:  {t_decode*1e3:.1f} ms for {args.gen-1} steps x "
          f"{args.tenants} tenants ({toks / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"server:  {m['batches']} batches, occupancy mean "
          f"{m['batch_occupancy_mean']:.2f} max {m['batch_occupancy_max']}, "
          f"{m['batch_fallbacks']} fallbacks, queue peak "
          f"{m['queue_depth_peak']}")
    print(f"pool:    {stats['pool']}  intern: {stats['intern']}")
    print(f"latency: p50 {m['latency']['p50_s']*1e3:.2f} ms  "
          f"p99 {m['latency']['p99_s']*1e3:.2f} ms")
    _print_tier_latency(m.get("tiers"))
    print(f"trace:   {m['trace']}")
    print(f"graphs:  {stats['graphs']}")
    if args.trace_out:
        server.dump_trace(args.trace_out)
        print(f"trace ring and spans written to {args.trace_out}")
    _print_kernels()
    for i in (0, args.tenants - 1):
        gen = torch.stack(states[i]["out"], dim=1)
        print(f"tenant{i} sample token ids:", gen[0, :12].tolist())
    return 0


def _run_cluster(args, cfg, params, device) -> int:
    from ..core import TDG
    from ..serving import ClusterFrontend

    kwargs = {"arch": args.arch, "smoke": args.smoke, "device": str(device),
              "layers": args.layers}
    registry = build_decode_registry(**kwargs)
    decode = registry.get("decode")
    max_len = args.prompt_len + args.gen

    states = []
    t0 = time.time()
    for i in range(args.tenants):
        batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed + 1 + i,
                             device)
        logits, caches, pos = prefill(params, cfg, batch, max_len=max_len)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        states.append({"tok": tok, "pos": pos, "caches": caches, "out": [tok]})
    _sync(device)
    t_prefill = time.time() - t0

    if args.workers:
        workers = [w.strip() for w in args.workers.split(",") if w.strip()]
    else:
        workers = args.cluster or None
    t0 = time.time()
    frontend = ClusterFrontend(
        workers=workers, registry="repro_torch.launch.serve:build_decode_registry",
        registry_kwargs=kwargs, max_batch=args.max_batch or args.tenants,
        max_wait_ms=args.max_wait_ms, token=args.token,
        continuous=False if args.request_level else None, device=device,
        name="decode-cluster")
    tiers = _tenant_tiers(args)
    pinned = {"params": _model.params_of(params)}
    for i in range(args.tenants):
        tdg = TDG(f"decode[{i}]")
        tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                     outs=["next", "caches"], name="decode")
        # params ship ONCE per worker (pinned); each step's request carries
        # only the varying decode state.
        frontend.register_tenant(f"tenant{i}", tdg, outputs=("next", "caches"),
                                 pinned=pinned, tier=tiers[i],
                                 rate=args.tenant_rate or None)
    t_spawn = time.time() - t0

    errors: list[BaseException] = []

    def tenant_loop(i: int) -> None:
        try:
            st = states[i]
            for _ in range(args.gen - 1):
                out = frontend.serve(f"tenant{i}", {
                    "tokens": st["tok"][:, None], "pos": st["pos"],
                    "caches": st["caches"]}, timeout=300)
                st["tok"], st["caches"] = out["next"].to(device), out["caches"]
                st["pos"] = st["pos"] + 1
                st["out"].append(st["tok"])
        except BaseException as e:   # surface thread failures, don't exit 0
            errors.append(e)

    threads = [threading.Thread(target=tenant_loop, args=(i,))
               for i in range(args.tenants)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_decode = time.time() - t0
    stats = frontend.stats()
    if args.trace_out:
        import json as _json
        with open(args.trace_out, "w") as f:
            _json.dump(frontend.trace(), f, indent=1)
        print(f"per-worker trace rings written to {args.trace_out}")
    frontend.close()
    if errors:
        raise errors[0]

    fr, agg = stats["frontend"], stats["aggregate"]
    toks = args.tenants * args.batch * (args.gen - 1)
    print(f"prefill: {t_prefill*1e3:.1f} ms for {args.tenants} tenants "
          f"x {args.batch}x{args.prompt_len}")
    print(f"cluster: {fr['workers']} workers ({fr['remote_workers']} remote) "
          f"ready+registered in {t_spawn*1e3:.0f} ms")
    print(f"decode:  {t_decode*1e3:.1f} ms for {args.gen-1} steps x "
          f"{args.tenants} tenants ({toks / max(t_decode, 1e-9):.1f} tok/s "
          f"over RPC)")
    print(f"fleet:   admitted {agg['admitted']}, {agg['batches']} batches, "
          f"coalesced {agg['coalesced_requests']}, aot_served "
          f"{agg['aot_served']}, hydrate failures "
          f"{agg['aot_hydrate_failures']}")
    print(f"routing: {stats['tenants']}")
    print(f"fleet intern: {agg['intern']}  pool: {agg['pool']}")
    print(f"frontend: deaths {fr['worker_deaths']}, requeues "
          f"{fr['requeues']}, artifacts shipped {fr['artifacts_shipped']}")
    print(f"wire:    {fr['wire']}")
    for i in (0, args.tenants - 1):
        gen = torch.stack([t.cpu() for t in states[i]["out"]], dim=1)
        print(f"tenant{i} sample token ids:", gen[0, :12].tolist())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--server", action="store_true",
                    help="multi-tenant RegionServer mode")
    ap.add_argument("--cluster", type=int, default=None, nargs="?", const=0,
                    help="distributed mode: worker process count "
                         "(0/omitted value = REPRO_CLUSTER_WORKERS)")
    ap.add_argument("--workers", default=None, metavar="SPEC,SPEC,...",
                    help="distributed mode with explicit worker specs: "
                         "comma-separated host:port of pre-started "
                         "`python -m repro_torch.serving.worker` nodes, plus the "
                         "literal 'local' to also spawn here; implies --cluster")
    ap.add_argument("--token", default=None,
                    help="RPC handshake auth token for --cluster/--workers "
                         "(default: $REPRO_RPC_TOKEN)")
    ap.add_argument("--tenants", type=int, default=4,
                    help="[--server/--cluster] concurrent decode tenants")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="[--server/--cluster] coalescing ceiling (0 = #tenants)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="[--server/--cluster] admission window for coalescing")
    ap.add_argument("--request-level", action="store_true",
                    help="[--server/--cluster] run-to-completion batching instead of "
                         "continuous (iteration-level)")
    ap.add_argument("--tiers", default=None, metavar="T0,T1,...",
                    help="[--server/--cluster] per-tenant QoS tiers, cycled over "
                         "tenants (e.g. '0,1'); default all tier 0")
    ap.add_argument("--tenant-rate", type=float, default=0.0,
                    help="[--server/--cluster] per-tenant token-bucket rate limit "
                         "in req/s (0 = unlimited)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="[--server/--cluster] dump the execution-pattern trace "
                         "ring(s) to PATH as JSON after the run (--server: with "
                         "the program's spans)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = build_config(args.arch, args.smoke, args.layers)
    with torch.no_grad():
        params = init_params(cfg, torch.Generator(device).manual_seed(args.seed))
        if args.cluster is not None or args.workers:
            return _run_cluster(args, cfg, params, device)
        if args.server:
            if args.trace_out:
                spans.enable()
            try:
                return _run_server(args, cfg, params, device)
            finally:
                spans.disable()
        return _run_single_stream(args, cfg, params, device)


if __name__ == "__main__":
    raise SystemExit(main())
