#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device and build: print the card's name and power limit
   (``nvidia-smi``), build both CUDA kernels from ``src/repro_torch/csrc``
   and print the build time and the compiler's register / shared memory
   report.
2. Kernels: hold each kernel against its plain PyTorch version on the
   card, at the slice's shapes and at small cases (GQA, MQA, MHA, ragged
   S, window, chunk, decode offset, cross attention, head dims 16-128;
   RMSNorm with residual, with a (B, S, H, hd) input, ragged and wide d),
   with atol = rtol = 2e-5 in f32 and 2e-2 in bf16. Time the kernel, its
   plain version and one PyTorch library call (``F.rms_norm``,
   ``F.scaled_dot_product_attention``, which the port never calls) with
   CUDA events at the slice's shapes.
3. Slice: full-width qwen2.5-3b (random weights from a seeded generator)
   prefills 4 tenants x batch 4 x 512 tokens, then serves 8 decode steps
   per tenant from 4 threads through the port's request-level
   ``RegionServer``. Checks: both kernels' launch counts rose (flash
   attention in prefill, RMSNorm in prefill and decode), no batch fell
   back to serial replay, some batch held more than one request, the
   structural intern cache was hit by tenants 2..4, and tenant 0's
   logits (prefill and one decode step) agree between the kernels and the
   plain versions within relative L2 2e-2.
4. Profile: one prefill and one more coalesced decode round under
   ``torch.profiler``, printing the card's busy and idle shares and the
   kernels that take the device time.

The last lines are one ``{"kernels": [...]}`` JSON object and then
``{"ok": true, "device": {...}}``. Needs a CUDA card and the repository
beside this file.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense; f32 off tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

TENANTS, BATCH, PROMPT, DECODE_STEPS = 4, 4, 512, 8


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median device time of one ``fn()`` call, each call timed by its own
    pair of CUDA events after an L2 flush (``flush.zero_()``). A ~1 ms spin
    kernel queued ahead keeps the card busy while the host enqueues the
    start event and ``fn``'s launches, so host dispatch time stays out of
    the measurement."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_ms(name: str, fn, flush: torch.Tensor) -> float | None:
    """Time a PyTorch library yardstick; None where this torch lacks it."""
    try:
        return time_ms(fn, flush=flush)
    except (TypeError, RuntimeError) as e:
        log(f"library yardstick {name} unavailable: {type(e).__name__}: {e}")
        return None


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max abs err {err:.3g}, atol=rtol={tol})")
    return err


def randn(*shape, dtype, gen) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------- kernels

def check_rmsnorm(rms, ref, gen) -> dict:
    cases = [  # (shape, x dtype, w dtype, residual)
        ((TENANTS * PROMPT, 2048), torch.bfloat16, torch.float32, False),  # prefill
        ((TENANTS * BATCH, 2048), torch.bfloat16, torch.float32, False),   # decode
        ((64, 2048), torch.float32, torch.float32, False),
        ((64, 2048), torch.bfloat16, torch.float32, True),
        ((64, 2048), torch.float32, torch.float32, True),
        ((2, 17, 16, 128), torch.bfloat16, torch.float32, False),          # (B,S,H,hd)
        ((2, 17, 16, 128), torch.float32, torch.bfloat16, True),
        ((33, 1000), torch.float32, torch.float32, False),                 # ragged d
        ((8, 8192), torch.bfloat16, torch.float32, True),                  # widest d
        ((5, 16), torch.float32, torch.float32, False),
    ]
    worst = 0.0
    for shape, xdt, wdt, res in cases:
        x = randn(*shape, dtype=xdt, gen=gen)
        w = randn(shape[-1], dtype=wdt, gen=gen)
        r = randn(*shape, dtype=xdt, gen=gen) if res else None
        err = compare(f"rmsnorm {shape} {xdt} res={res}", rms.rmsnorm(x, w, residual=r),
                      ref.rmsnorm_ref(x, w, residual=r), xdt)
        if shape[0] == TENANTS * PROMPT:
            worst = max(worst, err)
    log(f"rmsnorm: {len(cases)} cases agree (main-path max abs err {worst:.3g})")

    n, d = TENANTS * PROMPT, 2048
    x = randn(n, d, dtype=torch.bfloat16, gen=gen)
    w = randn(d, dtype=torch.float32, gen=gen)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: rms.rmsnorm(x, w), flush=flush)
    plain_ms = time_ms(lambda: ref.rmsnorm_ref(x, w), flush=flush)
    lib_ms = library_ms("F.rms_norm", lambda: F.rms_norm(x, (d,), w, 1e-6), flush)
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    flops = 4 * x.numel()
    mem_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    dec = randn(TENANTS * BATCH, d, dtype=torch.bfloat16, gen=gen)
    log(f"rmsnorm timing ({n}x{d} bf16): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.rms_norm {lib_ms} ms, bound {max(mem_ms, op_ms):.4f} ms; decode "
        f"{TENANTS * BATCH}x{d}: kernel {time_ms(lambda: rms.rmsnorm(dec, w), flush=flush):.4f} ms")
    return {"name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:33", "max_abs_err": worst,
            "tolerance": TOL[torch.bfloat16], "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(mem_ms, op_ms), "bound_us": max(mem_ms, op_ms) * 1e3,
            "bound_by": "bytes" if mem_ms >= op_ms else "operations",
            "shape": [n, d], "dtype": "bfloat16"}


def check_attention(fa, ref, gen) -> dict:
    cases = [  # (B, Sq, Sk, Hq, Hkv, D, dtype, kwargs)
        (TENANTS, PROMPT, PROMPT, 16, 2, 128, torch.bfloat16, {}),      # prefill
        (2, 256, 256, 8, 2, 64, torch.float32, {}),                     # GQA
        (2, 256, 256, 4, 1, 128, torch.bfloat16, {}),                   # MQA
        (2, 128, 128, 4, 4, 64, torch.float32, {}),                     # MHA
        (2, 100, 100, 4, 2, 64, torch.bfloat16, {}),                    # ragged S
        (2, 100, 100, 4, 2, 32, torch.float32, {}),
        (1, 256, 256, 4, 2, 64, torch.float32, {"window": 64}),
        (1, 256, 256, 4, 2, 64, torch.float32, {"window": 100}),
        (1, 256, 256, 4, 2, 64, torch.float32, {"chunk": 64}),
        (1, 256, 256, 4, 2, 128, torch.bfloat16, {"chunk": 128}),
        (2, 1, 128, 4, 2, 64, torch.float32, {"q_offset": 127}),        # decode
        (2, 64, 200, 4, 2, 64, torch.float32, {"causal": False}),       # cross
        (2, 64, 200, 4, 2, 128, torch.bfloat16, {"causal": False}),
        (2, 24, 24, 4, 2, 16, torch.float32, {}),                       # reduced configs
    ]
    worst = 0.0
    for B, Sq, Sk, Hq, Hkv, D, dt, kw in cases:
        q = randn(B, Sq, Hq, D, dtype=dt, gen=gen)
        k = randn(B, Sk, Hkv, D, dtype=dt, gen=gen)
        v = randn(B, Sk, Hkv, D, dtype=dt, gen=gen)
        err = compare(f"attention B{B} Sq{Sq} Sk{Sk} Hq{Hq} Hkv{Hkv} D{D} {dt} {kw}",
                      fa.flash_attention(q, k, v, **kw), ref.attention_ref(q, k, v, **kw), dt)
        if Sq == PROMPT:
            worst = max(worst, err)
    log(f"flash_attention: {len(cases)} cases agree (main-path max abs err {worst:.3g})")

    B, S, Hq, Hkv, D = TENANTS, PROMPT, 16, 2, 128
    q = randn(B, S, Hq, D, dtype=torch.bfloat16, gen=gen)
    k = randn(B, S, Hkv, D, dtype=torch.bfloat16, gen=gen)
    v = randn(B, S, Hkv, D, dtype=torch.bfloat16, gen=gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v), flush=flush)
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v), flush=flush)
    lib_ms = library_ms("F.scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    pairs = B * Hq * S * (S + 1) // 2          # causal (q, k) pairs this run needs
    flops = 4 * D * pairs                       # QK^T and PV, 2 flops a MAC each
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    mem_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    log(f"flash_attention timing ({B}x{S}, {Hq}/{Hkv} heads, D{D} bf16 causal): kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms} ms, bound "
        f"{max(mem_ms, op_ms):.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s achieved)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102", "max_abs_err": worst,
            "tolerance": TOL[torch.bfloat16], "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(mem_ms, op_ms), "bound_us": max(mem_ms, op_ms) * 1e3,
            "bound_by": "bytes" if mem_ms >= op_ms else "operations",
            "shape": [B, S, Hq, Hkv, D], "dtype": "bfloat16"}


# ---------------------------------------------------------------- slice

def device_profile(label: str, fn) -> None:
    """Run ``fn`` under torch.profiler; print its wall time, the card's busy
    and idle shares, and the kernels that took the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n += 1
    busy = sum(by_name.values())
    if not busy:
        log(f"profile {label}: wall {wall_us / 1e3:.1f} ms; device time not measured "
            f"(the profiler recorded no CUDA activity)")
        return
    groups = {"matmul (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass", "sm90"),
              "flash_attention kernel": ("fa_fwd",), "rmsnorm kernel": ("rmsnorm_kernel",)}
    shares = {g: 0.0 for g in groups}
    shares["other (casts, elementwise, softmax, copies)"] = 0.0
    for name, us in by_name.items():
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)),
                 "other (casts, elementwise, softmax, copies)")
        shares[g] += us
    log(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall_us:.1%}; idle {1 - busy / wall_us:.1%}), {n} device ops; "
        + "; ".join(f"{g} {us / 1e3:.2f} ms" for g, us in shares.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        log(f"  {us / 1e3:8.2f} ms  {name[:100]}")


def profile_phase(server, params, cfg, states, prompt, max_len) -> None:
    """Where the time goes, after the main path: one prefill and one more
    concurrent decode round (4 tenants, one coalesced step)."""
    from repro_torch.models import model as M

    device_profile("prefill (1 tenant, 4x512)",
                   lambda: M.prefill(params, cfg, {"tokens": prompt}, max_len))

    def decode_round():
        futures = [server.submit(f"tenant{i}", {
            "params": params, "tokens": st["tok"][:, None], "pos": st["pos"],
            "caches": st["caches"]}) for i, st in enumerate(states)]
        for f in futures:
            f.result(timeout=600)

    device_profile(f"decode round ({TENANTS} tenants x batch {BATCH})", decode_round)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def run_slice(rms, fa, registry) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import TDG
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import model as M
    from repro_torch.serving import RegionServer
    from repro_torch.training import make_serve_step

    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"slice: {cfg.name} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{nparams / 1e9:.3f}B params f32) initialized in {time.perf_counter() - t0:.1f} s")

    max_len = PROMPT + DECODE_STEPS + 1
    prompts = [prompt_tokens(cfg, BATCH, PROMPT, 1 + i, "cuda") for i in range(TENANTS)]
    decode = make_serve_step(cfg)

    # ---- main path: counts zeroed just before, read just after
    rms.reset_launches()
    fa.reset_launches()
    states, prefill_ms = [], []
    for i in range(TENANTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, pos = M.prefill(params, cfg, {"tokens": prompts[i]}, max_len)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        states.append({"tok": tok, "pos": pos, "caches": caches, "out": [tok],
                       "logits": logits})
    rms_prefill, fa_prefill = rms.launches, fa.launches

    server = RegionServer(max_batch=TENANTS, max_wait_ms=5.0, name="chip-smoke")
    errors: list[BaseException] = []
    try:
        for i in range(TENANTS):
            tdg = TDG(f"decode[{i}]")
            tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                         outs=["next", "caches"], name="decode")
            server.register_tenant(f"tenant{i}", tdg, outputs=("next", "caches"))

        def tenant_loop(i: int) -> None:
            try:
                st = states[i]
                for _ in range(DECODE_STEPS):
                    out = server.serve(f"tenant{i}", {
                        "params": params, "tokens": st["tok"][:, None],
                        "pos": st["pos"], "caches": st["caches"]}, timeout=600)
                    st["tok"], st["caches"] = out["next"], out["caches"]
                    st["pos"] = st["pos"] + 1
                    st["out"].append(st["tok"])
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=tenant_loop, args=(i,)) for i in range(TENANTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        rms_total, fa_total = rms.launches, fa.launches
        # ---- end of the main path
        stats = server.stats()
        if errors:
            raise errors[0]
        profile_phase(server, params, cfg, states, prompts[0], max_len)
    finally:
        server.close()

    m = stats["metrics"]
    toks = TENANTS * BATCH * DECODE_STEPS
    log(f"prefill: {sum(prefill_ms):.1f} ms for {TENANTS} tenants x {BATCH}x{PROMPT} "
        f"(per tenant {', '.join(f'{x:.1f}' for x in prefill_ms)} ms)")
    log(f"decode:  {t_decode * 1e3:.1f} ms for {DECODE_STEPS} steps x {TENANTS} tenants "
        f"({toks / t_decode:.1f} tok/s)")
    log(f"server:  {m['batches']} batches, occupancy mean {m['batch_occupancy_mean']:.2f} "
        f"max {m['batch_occupancy_max']}, {m['batch_fallbacks']} fallbacks, queue peak "
        f"{m['queue_depth_peak']}; pool {stats['pool']}; intern {stats['intern']}")
    log(f"latency: p50 {m['latency']['p50_s'] * 1e3:.2f} ms  p99 "
        f"{m['latency']['p99_s'] * 1e3:.2f} ms")
    log(f"launches: rmsnorm {rms_prefill} in prefill + {rms_total - rms_prefill} in decode; "
        f"flash_attention {fa_prefill} in prefill + {fa_total - fa_prefill} in decode")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if not fa_prefill > 0:
        raise AssertionError("flash attention kernel never launched in prefill")
    if not (rms_prefill > 0 and rms_total > rms_prefill):
        raise AssertionError("rmsnorm kernel did not launch in both prefill and decode")
    if m["batch_fallbacks"] != 0:
        raise AssertionError(f"{m['batch_fallbacks']} batches fell back to serial replay")
    if not m["batch_occupancy_max"] > 1:
        raise AssertionError("no decode batch coalesced more than one tenant")
    if stats["intern"]["hits"] < TENANTS - 1:
        raise AssertionError(f"intern hits {stats['intern']['hits']} < {TENANTS - 1}")
    if m["completed"] != TENANTS * DECODE_STEPS or m["failed"]:
        raise AssertionError(f"completed {m['completed']}, failed {m['failed']}")
    for st in states:
        gen = torch.stack(st["out"], dim=1)
        if gen.shape != (BATCH, DECODE_STEPS + 1) or not (
                (gen >= 0) & (gen < cfg.vocab_size)).all():
            raise AssertionError(f"bad generated tokens {gen.shape}")
    log("tenant0 sample token ids:", torch.stack(states[0]["out"], 1)[0].tolist())

    # ---- kernels vs plain versions on the full model, tenant 0
    with torch.no_grad():
        logits_k = states[0]["logits"]
        with registry.kernel_mode_scope("ref"):
            logits_r, caches_r, pos_r = M.prefill(params, cfg, {"tokens": prompts[0]}, max_len)
        tok0 = states[0]["out"][0]
        if logits_k.shape != (BATCH, 1, cfg.padded_vocab) or not torch.isfinite(
                logits_k[..., :cfg.vocab_size]).all():
            raise AssertionError(f"prefill logits {tuple(logits_k.shape)} not finite")
        pre_err = rel_l2(logits_k[..., :cfg.vocab_size], logits_r[..., :cfg.vocab_size])
        pre_abs = (logits_k - logits_r)[..., :cfg.vocab_size].abs().max().item()
        _, caches_k, pos_k = M.prefill(params, cfg, {"tokens": prompts[0]}, max_len)
        dec_k, _ = M.decode_step(params, cfg, tok0[:, None], pos_k, caches_k)
        with registry.kernel_mode_scope("ref"):
            dec_r, _ = M.decode_step(params, cfg, tok0[:, None], pos_r, caches_r)
        dec_err = rel_l2(dec_k[..., :cfg.vocab_size], dec_r[..., :cfg.vocab_size])
        dec_abs = (dec_k - dec_r)[..., :cfg.vocab_size].abs().max().item()
    log(f"logits kernels vs plain (tenant 0): prefill rel L2 {pre_err:.3g} (max abs "
        f"{pre_abs:.3g}), decode step rel L2 {dec_err:.3g} (max abs {dec_abs:.3g})")
    if pre_err > 2e-2 or dec_err > 2e-2:
        raise AssertionError("kernel and plain logits differ by more than rel L2 2e-2")
    return {"rmsnorm": rms_total, "flash_attention": fa_total}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import _build, ref, registry
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rmsnorm as rms
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    card = smi()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) or 'cached'})")
    for name in _build.SOURCES:   # ptxas -v: per-kernel registers and spills
        text = _build.log_path(name).read_text() if _build.log_path(name).exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
        if regs:
            log(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                f"spill stores up to {max(spills, default=0)} bytes")

    gen = torch.Generator("cuda").manual_seed(1234)
    kernels = [check_rmsnorm(rms, ref, gen), check_attention(fa, ref, gen)]
    launches = run_slice(rms, fa, registry)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"] > 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    log(json.dumps({"kernels": kernels, "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
