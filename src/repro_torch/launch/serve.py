"""Serving driver: batched prefill + decode, single-stream or server.

Port of ``repro.launch.serve`` (single-stream and ``--server``; the cluster
modes wait for the cluster tier, ROADMAP.md queue A item 14). Runs on the
CUDA card; ``--device cpu`` is the only way onto the CPU, and with no card
and no ``--device cpu`` it raises.

``--arch`` is one of the ported configs: ``qwen2.5-3b`` (dense),
``qwen3-moe-30b-a3b`` (MoE) and ``mamba2-370m`` (SSM).

* **Single-stream** (default): one prompt batch, prefill, then a greedy
  decode loop.

      PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
          --batch 4 --prompt-len 64 --gen 32

* **Multi-tenant server** (``--server``): N tenants each own a decode-step
  TDG (same structure, same payload, private caches, shared params) and
  drive it from N threads through the request-level
  :class:`repro_torch.serving.RegionServer`, which coalesces concurrent
  steps into one ``torch.func.vmap``-batched replay.

      PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
          --server --tenants 4

``--smoke`` runs the reduced config (2 layers, d_model 64). The full
qwen3-moe-30b-a3b keeps f32 params (122 GB at 48 layers), so on one 80 GB
card pass ``--layers 16``.
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import torch

from ..configs import ARCHS, get_config, reduced
from ..kernels import flash_attention as _fa
from ..kernels import moe_gmm as _gmm
from ..kernels import rmsnorm as _rms
from ..kernels import ssd_scan as _ssd
from ..models import init_params, prefill
from ..training import make_serve_step


def resolve_device(name: str) -> torch.device:
    """The device to run on; a CUDA device with no card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for --device {name}; pass "
                           f"--device cpu to run on the CPU")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int,
                  device: torch.device) -> torch.Tensor:
    """Random prompt ids in [2, vocab) from a CPU generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(2, cfg.vocab_size, (batch, prompt_len), generator=g,
                         dtype=torch.int32).to(device)


def _print_kernels() -> None:
    print(f"kernels: rmsnorm {_rms.launches} launches, flash_attention "
          f"{_fa.launches}, grouped_matmul {_gmm.launches}, ssd_intra_chunk "
          f"{_ssd.launches}")


def _run_single_stream(args, cfg, params, device) -> int:
    tokens = prompt_tokens(cfg, args.batch, args.prompt_len, args.seed + 1, device)
    max_len = args.prompt_len + args.gen
    t0 = time.time()
    logits, caches, pos = prefill(params, cfg, {"tokens": tokens}, max_len=max_len)
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
        tokens = prompt_tokens(cfg, args.batch, args.prompt_len, args.seed + 1 + i,
                               device)
        logits, caches, pos = prefill(params, cfg, {"tokens": tokens},
                                      max_len=max_len)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        states.append({"tok": tok, "pos": pos, "caches": caches, "out": [tok]})
    _sync(device)
    t_prefill = time.time() - t0

    server = RegionServer(max_batch=args.max_batch or args.tenants,
                          max_wait_ms=args.max_wait_ms, name="decode-server")
    for i in range(args.tenants):
        # One decode-step region per tenant, structurally identical across
        # tenants (same payload object), so they intern to one entry.
        tdg = TDG(f"decode[{i}]")
        tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                     outs=["next", "caches"], name="decode")
        server.register_tenant(f"tenant{i}", tdg, outputs=("next", "caches"))

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
    _print_kernels()
    for i in (0, args.tenants - 1):
        gen = torch.stack(states[i]["out"], dim=1)
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
                    help="multi-tenant request-level RegionServer mode")
    ap.add_argument("--tenants", type=int, default=4,
                    help="[--server] concurrent decode tenants")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="[--server] coalescing ceiling (0 = #tenants)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="[--server] admission window for coalescing")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    with torch.no_grad():
        params = init_params(cfg, torch.Generator(device).manual_seed(args.seed))
        if args.server:
            return _run_server(args, cfg, params, device)
        return _run_single_stream(args, cfg, params, device)


if __name__ == "__main__":
    raise SystemExit(main())
