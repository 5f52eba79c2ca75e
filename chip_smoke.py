#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device and build: print the card's name and power limit
   (``nvidia-smi``), build the eight CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` each, in parallel) and print the
   build time and the compiler's register / shared memory report.
2. Kernels: hold each kernel against its plain PyTorch version on the
   card, at the paths' shapes and at small cases, each case through the
   public wrapper with one counted launch of the kernel that
   ``kernel_for`` picks by dtype and shape:
   RMSNorm (residual, (B, S, H, hd) input, ragged and wide d; d a multiple
   of 16 16-byte vectors takes the register-resident kernel, with its
   edges: 16-lane rows, 2-8 warps a row, bf16 w, a partly filled lane, a
   grid tail) and flash attention (GQA, MQA, MHA, ragged S, window, chunk,
   decode offset, cross attention, head dims 16-128; bf16 at head dim 64 /
   128 takes the TMA + wgmma kernel, with its edges: decode-shaped, a
   window, Sk off its 128-key tile) at atol = rtol = 2e-5 in f32 and 2e-2
   in bf16; grouped matmul (the reference's cases in f32 and bf16, ragged
   C, d and f, the MoE prefill and decode shapes; bf16 with d, f multiples
   of 8 takes the TMA + wgmma kernel, with C of 1, 65, 200 and 300 and d, f
   off its tiles) at atol = TOL·d, rtol = TOL as the reference's test, plus
   relative L2 <= 1e-5 (f32) / 5e-3 (bf16); SSD (the reference's cases, the
   mamba2 shape, ragged S, a chunk of 12, N 96, more heads a group than a
   block takes, each with an init_state, and a prefill state chained into
   the sequential decode recurrence; P <= 64 takes the 3xTF32 tensor-core
   kernel, head dim 128 the first design) at 1e-3 against ``ssd_ref`` and
   ``ssd_chunked_ref``; at the mamba2 shape the tensor-core kernel's y and
   end-state also within relative L2 SSD_REL of the plain version in f32,
   where single-pass TF32 (the plain version with TF32 matmuls) must fall
   outside it. Time each kernel, its plain version, its first design
   (through its raw launcher) and one PyTorch library call where one
   computes the same function (``F.rms_norm``,
   ``F.scaled_dot_product_attention``, ``torch.bmm``; the port never calls
   them) with CUDA events at the paths' shapes: RMSNorm at the prefill,
   decode, qk-norm and mamba2 block shapes beside the launch floor (a
   one-element ``zero_()``) timed the same way, flash attention at the
   dense and MoE prefill shapes, grouped matmul at prefill and decode, SSD
   at the mamba2 shape and its bound both ways (f32 CUDA cores, and bytes
   against 3xTF32 tensor-core operations).
3. Paths, one model at a time (the previous one freed first), each driven
   the same way: 4 tenants each prefill batch 4 x 512 tokens, then 8
   greedy decode steps each from 4 threads through the port's
   request-level ``RegionServer`` (one-task decode TDGs). Kernel launch
   counts are set to 0 just before each path and read just after. Every
   path checks: no batch fell back to serial replay, some batch held more
   than one tenant, the structural intern cache was hit by tenants 2..4.
   The first designs of all four kernels launch 0 times on every path.
   a. qwen2.5-3b, full width and depth: the TMA + wgmma flash attention
      launched 36 times a tenant in prefill, the register-resident
      RMSNorm in prefill and decode; tenant 0's logits (prefill and one
      decode step) with the kernels against the plain versions within
      relative L2 2e-2.
   b. qwen3-moe-30b-a3b, full width, 16 of 48 layers (f32 params do not
      fit one card): the TMA + wgmma grouped matmul launched 48 times a
      tenant in prefill and in decode, the TMA + wgmma flash attention 16
      times a tenant and RMSNorm in prefill and decode; in f32 (same
      weights) tenant 0's prefill logits and one decode step within
      relative L2 1e-3, the plain run taking the kernel run's top-k expert
      choices (printed: how many its own router would change); in bf16
      layer 0's MoE on one input within relative L2 2e-2 (identical
      routing); the bf16 whole-model gap, unpinned, printed without limit.
   c. mamba2-370m, full width and depth: the tensor-core SSD launched 48
      times a tenant in prefill and never in decode, RMSNorm in both; in
      f32 (same weights) tenant 0's prefill logits and one decode step
      within relative L2 1e-3; in bf16 layer 0's mixer on one input
      within relative L2 2e-2;
      the bf16 gap at depths 3, 12, 24 and 48 printed without limit
      (one-ulp differences grow with depth through the random-weight
      stack).
4. Profile, for each path: one prefill and one more coalesced decode
   round under ``torch.profiler``, printing the card's busy and idle
   shares and the kernels that take the device time.
5. Taskgraph: the paper's record -> fuse -> lower -> replay path on the
   paper's workloads (``repro_torch.workloads``), each at a coarse and a
   fine grain, at sizes where the card does real work: Cholesky n 16,384
   (nb 16, 32), Heat 16,384^2 x 2 iterations (nb 16, 64), N-body 16,384
   particles (nb 16), AXPY and DOTP n 2^28 (nb 16, 1024), RMSNorm blocks
   65,536 x 2048 bf16 at depth 2 (nb 16, 256) and causal attention blocks,
   64 x 2048 x 16 heads of 128 in bf16 (nb 16) and the reference's 16 x
   128 x 4 heads of 64 in f32 (nb 4). Each run records through
   ``@taskgraph``, replays through ``ReplayExecutor`` (one CUDA graph,
   captured at its first call), replays fused and uncaptured
   (``lower_tdg(jit=False)``), and runs ``EagerExecutor(n_workers=4)``; the
   workload's ``verify`` holds the captured replay, and the three must
   agree per output within a stated share of its largest magnitude. No
   class may fall back to the unrolled form; the RMSNorm and attention
   classes are fused by ``vmap``, and their kernels (``rmsnorm_sm90``,
   ``flash_attention_sm90``, the f32 first-design ``flash_attention``) must
   launch inside the captured graph: their counters rise by twice one
   uncaptured replay's launches at the first call (warm-up and capture),
   stay still over the replays, and a profiler trace of three replays shows
   the kernel's name. One line per run gives tasks, waves, fused classes,
   record, eager (median of 5), captured and uncaptured replay (median of
   5) times, and eager's ``ExecStats``. Launch counts are set to 0 just
   before the phase and read just after.

The last lines are one ``{"kernels": [...]}`` JSON object, one
``{"taskgraph": [...]}`` object and then ``{"ok": true, "device": {...}}``.
Needs a CUDA card and the repository beside this file.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
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
PEAK_FLOPS = {torch.bfloat16: 989e12, "tf32": 495e12,
              torch.float32: 67e12}   # dense; f32 off the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GMM_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
SSD_TOL = 1e-3
# relative L2 of the 3xTF32 SSD kernel's y and end-state at the mamba2 shape:
# 3xTF32 emulated on the CPU gives ~3e-7, single-pass TF32 ~3e-4
SSD_REL = 1e-5

TENANTS, BATCH, PROMPT, DECODE_STEPS = 4, 4, 512, 8
TG_TOKENS = 65536                   # the taskgraph phase's rmsnorm_blocks rows (d 2048)
TG_BF16_ATTN = (64, 2048, 16, 128)  # its bf16 attention_blocks: seqs, seq, heads, hd
TG_F32_ATTN = (16, 128, 128, 4, 4, 64)   # its f32 one: B, Sq, Sk, Hq, Hkv, D
FIRST_DESIGNS = ("flash_attention", "grouped_matmul", "rmsnorm",
                 "ssd_chunk")   # kept for the dtypes and shapes the new kernels do not take
MOE_LAYERS = 16                     # of 48: f32 params of all 48 take 122 GB


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float | None = None) -> float:
    torch.cuda.synchronize()
    rtol = atol if rtol is None else rtol
    err = (got.float() - want.float()).abs().max().item()
    if got.shape != want.shape or not torch.allclose(got.float(), want.float(),
                                                     atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max abs err {err:.3g}, atol {atol:.3g}, rtol {rtol:.3g})")
    return err


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def randn(*shape, dtype, gen, scale: float = 1.0) -> torch.Tensor:
    return (torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)
            * scale).to(dtype)


def bound(nbytes: int, flops: float, dtype) -> tuple[float, str]:
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(mem_ms, op_ms), "bytes" if mem_ms >= op_ms else "operations"


def entry(name, source, replaces, err, tol, kernel_ms, plain_ms, lib_ms, bound_ms,
          bound_by, shape, dtype) -> dict:
    """One kernel's record in the ``{"kernels": [...]}`` line."""
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "tolerance": tol, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": shape, "dtype": dtype}


def one_launch(name: str, mod, kernel: str, run):
    """``run()`` must count exactly one launch, of ``kernel``."""
    before = dict(mod.launches_by_kernel)
    out = run()
    rose = {k: n - before[k] for k, n in mod.launches_by_kernel.items() if n != before[k]}
    if rose != {kernel: 1}:
        raise AssertionError(f"{name}: want one launch of {kernel}, counted {rose}")
    return out


def check_case(name: str, mod, kernel: str, run, want: torch.Tensor, atol: float,
               rtol: float | None = None) -> tuple[torch.Tensor, float]:
    """Run one case through the public wrapper, require that exactly one
    launch of ``kernel`` (the one ``mod.kernel_for`` picks) was counted, and
    compare with the plain version."""
    got = one_launch(name, mod, kernel, run)
    return got, compare(f"{name} [{kernel}]", got, want, atol, rtol)


def design_line(label: str, kernel_ms: float, first_ms: float, lib_name: str,
                lib_ms: float | None, flops: float, b_ms: float, b_by: str) -> None:
    """One shape's timing of both designs beside the bound and the yardstick."""
    log(f"  {label}: kernel {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / kernel_ms:.1%} of the {b_by} bound {b_ms:.4f} ms); first design "
        f"{first_ms:.4f} ms ({flops / first_ms / 1e9:.1f} TFLOP/s, {b_ms / first_ms:.1%}); "
        f"{lib_name} {lib_ms} ms; new / first {kernel_ms / first_ms:.3f}")


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
        ((4, 512, 32, 128), torch.bfloat16, torch.float32, False),         # qwen3 qk-norm
        ((4, 512, 1024), torch.bfloat16, torch.float32, False),            # mamba2 block
        ((33, 1000), torch.float32, torch.float32, False),                 # ragged d
        ((8, 8192), torch.bfloat16, torch.float32, True),                  # widest d
        ((5, 16), torch.float32, torch.float32, False),
        # the register-resident kernel's edges: 16-lane rows, widths 1024 and
        # 2048 in both dtypes, w in bf16, 2-8 warps a row, a partly filled
        # lane (48 vectors), a grid tail, f32 at d 64 (16 lanes)
        ((3, 7, 4, 128), torch.bfloat16, torch.bfloat16, True),
        ((65, 1024), torch.float32, torch.bfloat16, False),
        ((65, 1024), torch.bfloat16, torch.bfloat16, True),
        ((33, 2048), torch.float32, torch.bfloat16, True),
        ((16, 4096), torch.bfloat16, torch.bfloat16, False),
        ((6, 8192), torch.float32, torch.float32, True),
        ((9, 384), torch.bfloat16, torch.float32, False),
        ((1, 2048), torch.bfloat16, torch.float32, True),
        ((40_001, 128), torch.bfloat16, torch.float32, False),
        ((11, 64), torch.float32, torch.float32, True),
        # the taskgraph phase's rmsnorm_blocks: a fused wave (65,536 rows, the
        # vmap rule folding 16 or 256 blocks into one launch) and one task of
        # each grain in eager
        ((TG_TOKENS, 2048), torch.bfloat16, torch.float32, False),
        ((TG_TOKENS // 16, 2048), torch.bfloat16, torch.float32, False),
        ((TG_TOKENS // 256, 2048), torch.bfloat16, torch.float32, False),
    ]
    worst, by_kernel = 0.0, {}
    for shape, xdt, wdt, res in cases:
        x = randn(*shape, dtype=xdt, gen=gen)
        w = randn(shape[-1], dtype=wdt, gen=gen)
        r = randn(*shape, dtype=xdt, gen=gen) if res else None
        kernel = rms.kernel_for(xdt, shape[-1])
        _, err = check_case(f"rmsnorm {shape} {xdt} w {wdt} res={res}", rms, kernel,
                            lambda: rms.rmsnorm(x, w, residual=r),
                            ref.rmsnorm_ref(x, w, residual=r), TOL[xdt])
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        if shape[0] == TENANTS * PROMPT:
            worst = max(worst, err)
    log(f"rmsnorm: {len(cases)} cases agree ({by_kernel}; main-path max abs err {worst:.3g})")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    one = torch.empty(1, device="cuda")
    floor_ms = time_ms(one.zero_, flush=flush)   # the cheapest launch PyTorch makes
    log(f"rmsnorm timing (bf16 x, f32 w; first design through its raw launcher); a "
        f"one-element zero_() takes {floor_ms:.4f} ms through the same events:")
    shapes = {}
    for label, (n, d) in (("prefill", (TENANTS * PROMPT, 2048)),
                          ("decode", (TENANTS * BATCH, 2048)),
                          ("qk-norm", (TENANTS * PROMPT * 32, 128)),
                          ("mamba2 block", (TENANTS * PROMPT, 1024)),
                          ("taskgraph fused wave", (TG_TOKENS, 2048))):
        x = randn(n, d, dtype=torch.bfloat16, gen=gen)
        w = randn(d, dtype=torch.float32, gen=gen)
        kernel_ms = time_ms(lambda: rms.rmsnorm(x, w), flush=flush)
        first_ms = time_ms(lambda: rms.launch_kernel("rmsnorm", x, w), flush=flush)
        plain_ms = time_ms(lambda: ref.rmsnorm_ref(x, w), flush=flush)
        lib_ms = library_ms("F.rms_norm", lambda: F.rms_norm(x, (d,), w, 1e-6), flush)
        b_ms, b_by = bound(2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
                           4 * x.numel(), torch.float32)
        log(f"  {label} ({n}, {d}): kernel {kernel_ms:.4f} ms ({b_ms / kernel_ms:.1%} of the "
            f"{b_by} bound {b_ms:.4f} ms); first design {first_ms:.4f} ms; new / first "
            f"{kernel_ms / first_ms:.3f}; plain {plain_ms:.4f} ms; F.rms_norm {lib_ms} ms")
        shapes[label] = {"shape": [n, d], "ms": kernel_ms, "first_design_ms": first_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
    shapes["decode"]["launch_floor_ms"] = floor_ms
    pre = shapes["prefill"]
    e = entry("rmsnorm", "rmsnorm_sm90.cu", "src/repro/kernels/rmsnorm.py:33", worst,
              TOL[torch.bfloat16], pre["ms"], pre["plain_ms"], pre["library_ms"],
              pre["bound_ms"], pre["bound_by"], pre["shape"], "bfloat16")
    e["first_design_ms"], e["by_shape"] = pre["first_design_ms"], shapes
    return e


def check_attention(fa, ref, gen) -> dict:
    cases = [  # (B, Sq, Sk, Hq, Hkv, D, dtype, kwargs)
        (TENANTS, PROMPT, PROMPT, 16, 2, 128, torch.bfloat16, {}),      # dense prefill
        (TENANTS, PROMPT, PROMPT, 32, 4, 128, torch.bfloat16, {}),      # qwen3-moe prefill
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
        # the TMA + wgmma kernel's edges: decode-shaped, window, Sk off its 128-key tile
        (2, 1, 128, 4, 2, 128, torch.bfloat16, {"q_offset": 127}),
        (1, 256, 256, 4, 2, 128, torch.bfloat16, {"window": 100}),
        (2, 200, 200, 4, 2, 64, torch.bfloat16, {}),
        (2, 200, 200, 4, 2, 128, torch.bfloat16, {}),
        (2, 100, 150, 8, 2, 64, torch.bfloat16, {"q_offset": 37}),
        (1, 256, 256, 4, 2, 128, torch.bfloat16, {"chunk": 64}),
        # the taskgraph phase's attention_blocks, one task (4 sequences): bf16
        # 16/16 heads of 128 at 2048; f32 4/4 heads of 64 at 128, fused (16
        # sequences) and one task
        (4, 2048, 2048, 16, 16, 128, torch.bfloat16, {}),
        (*TG_F32_ATTN, torch.float32, {}),
        (TG_F32_ATTN[0] // 4, *TG_F32_ATTN[1:], torch.float32, {}),
    ]
    worst, by_kernel = 0.0, {}
    for B, Sq, Sk, Hq, Hkv, D, dt, kw in cases:
        q = randn(B, Sq, Hq, D, dtype=dt, gen=gen)
        k = randn(B, Sk, Hkv, D, dtype=dt, gen=gen)
        v = randn(B, Sk, Hkv, D, dtype=dt, gen=gen)
        kernel = fa.kernel_for(dt, D)
        _, err = check_case(f"attention B{B} Sq{Sq} Sk{Sk} Hq{Hq} Hkv{Hkv} D{D} {dt} {kw}",
                            fa, kernel, lambda: fa.flash_attention(q, k, v, **kw),
                            ref.attention_ref(q, k, v, **kw), TOL[dt])
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        if Sq == PROMPT:
            worst = max(worst, err)
    log(f"flash_attention: {len(cases)} cases agree ({by_kernel}; main-path max abs err "
        f"{worst:.3g})")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    shapes = {}
    log("flash_attention timing (bf16 causal, D 128; first design through its raw launcher):")
    for label, (B, S, Hq, Hkv, D) in (("dense prefill", (TENANTS, PROMPT, 16, 2, 128)),
                                      ("moe prefill", (TENANTS, PROMPT, 32, 4, 128))):
        q = randn(B, S, Hq, D, dtype=torch.bfloat16, gen=gen)
        k = randn(B, S, Hkv, D, dtype=torch.bfloat16, gen=gen)
        v = randn(B, S, Hkv, D, dtype=torch.bfloat16, gen=gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v), flush=flush)
        first_ms = time_ms(lambda: fa.launch_kernel("flash_attention", q, k, v, True, -1, 0,
                                                    D ** -0.5, 0), flush=flush)
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v), flush=flush)
        lib_ms = library_ms("F.scaled_dot_product_attention",
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        pairs = B * Hq * S * (S + 1) // 2          # causal (q, k) pairs this run needs
        flops = 4 * D * pairs                       # QK^T and PV, 2 flops a MAC each
        b_ms, b_by = bound(sum(t.numel() * t.element_size() for t in (q, k, v, q)), flops,
                           torch.bfloat16)
        design_line(f"{label} {B}x{S}, {Hq}/{Hkv} heads", kernel_ms, first_ms, "SDPA",
                    lib_ms, flops, b_ms, b_by)
        log(f"    plain {plain_ms:.4f} ms")
        shapes[label] = {"shape": [B, S, Hq, Hkv, D], "ms": kernel_ms, "first_design_ms": first_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
    # the taskgraph phase's bf16 fused wave: 64 sequences in one launch (the
    # plain version would hold 16 GiB of scores: not timed there)
    B, S, H, D = TG_BF16_ATTN
    q, k, v = (randn(B, S, H, D, dtype=torch.bfloat16, gen=gen) for _ in range(3))
    kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v), flush=flush)
    lib_ms = library_ms("F.scaled_dot_product_attention",
                        lambda: F.scaled_dot_product_attention(
                            *(t.transpose(1, 2) for t in (q, k, v)), is_causal=True), flush)
    flops = 4 * D * B * H * S * (S + 1) // 2
    b_ms, b_by = bound(4 * q.numel() * q.element_size(), flops, torch.bfloat16)
    log(f"  taskgraph fused wave {B}x{S}, {H}/{H} heads: kernel {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s, {b_ms / kernel_ms:.1%} of the {b_by} bound "
        f"{b_ms:.4f} ms); SDPA {lib_ms} ms")
    shapes["taskgraph fused wave"] = {"shape": [B, S, H, H, D], "ms": kernel_ms,
                                      "plain_ms": None, "library_ms": lib_ms,
                                      "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v
    dense = shapes["dense prefill"]
    e = entry("flash_attention", "flash_attention_sm90.cu",
              "src/repro/kernels/flash_attention.py:102", worst, TOL[torch.bfloat16],
              dense["ms"], dense["plain_ms"], dense["library_ms"], dense["bound_ms"],
              dense["bound_by"], dense["shape"], "bfloat16")
    e["first_design_ms"], e["by_shape"] = dense["first_design_ms"], shapes

    # the first design on its own path: the taskgraph phase's f32 attention,
    # a fused wave of 16 sequences (the reference's attention_blocks defaults)
    B, S, _, Hq, Hkv, D = TG_F32_ATTN
    q = randn(B, S, Hq, D, dtype=torch.float32, gen=gen)
    k, v = (randn(B, S, Hkv, D, dtype=torch.float32, gen=gen) for _ in range(2))
    first = fa.KERNELS[1]
    got, err = check_case("attention taskgraph f32 fused wave", fa, first,
                          lambda: fa.flash_attention(q, k, v), ref.attention_ref(q, k, v),
                          TOL[torch.float32])
    kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v), flush=flush)
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v), flush=flush)
    lib_ms = library_ms("F.scaled_dot_product_attention",
                        lambda: F.scaled_dot_product_attention(
                            *(t.transpose(1, 2) for t in (q, k, v)), is_causal=True), flush)
    flops = 4 * D * B * Hq * S * (S + 1) // 2
    b_ms, b_by = bound(4 * q.numel() * q.element_size(), flops, torch.float32)
    log(f"flash_attention first design (f32, taskgraph fused wave {B}x{S}, {Hq}/{Hkv} "
        f"heads of {D}): {kernel_ms:.4f} ms ({b_ms / kernel_ms:.1%} of the {b_by} bound "
        f"{b_ms:.4f} ms); plain {plain_ms:.4f} ms; SDPA {lib_ms} ms; max abs err {err:.3g}")
    e_first = entry("flash_attention (first design)", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:102", err, TOL[torch.float32],
                    kernel_ms, plain_ms, lib_ms, b_ms, b_by, [B, S, Hq, Hkv, D], "float32")
    return e, e_first


def check_grouped_matmul(gmm, ref, gen) -> dict:
    E, d, f = 128, 2048, 768                    # qwen3-moe experts
    c_pre, c_dec = 160, 8 * TENANTS             # prefill capacity; 4 decode tenants folded
    cases = [(4, 64, 128, 128), (2, 100, 256, 128), (8, 32, 128, 256),   # the reference's
             (3, 37, 128, 64),                  # ragged C
             (2, 64, 100, 64),                  # ragged d
             (2, 40, 128, 60),                  # ragged f
             (3, 13, 99, 45),                   # all ragged
             (E, c_pre, d, f), (E, c_pre, f, d), (E, c_dec, d, f),   # MoE prefill, decode
             # the TMA + wgmma kernel's edges: C of 1, 65 and 200 rows, d and f
             # multiples of 8 off its 64 x 128 tiles
             (2, 1, 256, 128), (2, 65, 256, 128), (2, 200, 256, 128), (3, 40, 136, 200),
             (2, 300, 128, 256)]
    worst, by_kernel = 0.0, {}
    for case in cases:
        for dt in (torch.float32, torch.bfloat16):
            e, c, dd, ff = case
            x = randn(e, c, dd, dtype=dt, gen=gen, scale=0.3)
            w = randn(e, dd, ff, dtype=dt, gen=gen, scale=0.3)
            kernel = gmm.kernel_for(dt, dd, ff)
            got, err = check_case(f"grouped_matmul {case} {dt}", gmm, kernel,
                                  lambda: gmm.grouped_matmul(x, w),
                                  ref.grouped_matmul_ref(x, w), TOL[dt] * dd, TOL[dt])
            rl2 = rel_l2(got, ref.grouped_matmul_ref(x, w))
            if rl2 > GMM_REL[dt]:
                raise AssertionError(f"grouped_matmul {case} {dt}: rel L2 {rl2:.3g} > "
                                     f"{GMM_REL[dt]}")
            by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
            if case == (E, c_pre, d, f) and dt == torch.bfloat16:
                worst = err
    log(f"grouped_matmul: {2 * len(cases)} cases agree ({by_kernel}; prefill bf16 max abs "
        f"err {worst:.3g})")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    shapes = {}
    log("grouped_matmul timing (bf16; first design through its raw launcher):")
    for label, c in (("prefill", c_pre), ("decode", c_dec)):
        x = randn(E, c, d, dtype=torch.bfloat16, gen=gen, scale=0.3)
        w = randn(E, d, f, dtype=torch.bfloat16, gen=gen, scale=0.3)
        kernel_ms = time_ms(lambda: gmm.grouped_matmul(x, w), flush=flush)
        first_ms = time_ms(lambda: gmm.launch_kernel("grouped_matmul", x, w), flush=flush)
        plain_ms = time_ms(lambda: ref.grouped_matmul_ref(x, w), flush=flush)
        lib_ms = library_ms("torch.bmm", lambda: torch.bmm(x, w), flush)
        flops = 2 * E * c * d * f
        b_ms, b_by = bound(2 * (x.numel() + w.numel() + E * c * f), flops, torch.bfloat16)
        design_line(f"{label} {E}x{c}x{d} @ {E}x{d}x{f}", kernel_ms, first_ms, "torch.bmm",
                    lib_ms, flops, b_ms, b_by)
        log(f"    plain {plain_ms:.4f} ms")
        shapes[label] = {"shape": [E, c, d, f], "ms": kernel_ms, "first_design_ms": first_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
    pre = shapes["prefill"]
    e = entry("grouped_matmul", "grouped_matmul_sm90.cu", "src/repro/kernels/moe_gmm.py:41",
              worst, TOL[torch.bfloat16] * d, pre["ms"], pre["plain_ms"], pre["library_ms"],
              pre["bound_ms"], pre["bound_by"], pre["shape"], "bfloat16")
    e["first_design_ms"], e["by_shape"] = pre["first_design_ms"], shapes
    e["decode_ms"], e["decode_bound_ms"] = shapes["decode"]["ms"], shapes["decode"]["bound_ms"]
    return e


def _ssd_inputs(gen, Bz, S, H, P, G, N):
    x = randn(Bz, S, H, P, dtype=torch.float32, gen=gen)
    dt = randn(Bz, S, H, dtype=torch.float32, gen=gen).abs() * 0.1 + 0.01
    A = -randn(H, dtype=torch.float32, gen=gen).abs() - 0.1
    Bm = randn(Bz, S, G, N, dtype=torch.float32, gen=gen, scale=0.5)
    Cm = randn(Bz, S, G, N, dtype=torch.float32, gen=gen, scale=0.5)
    D = randn(H, dtype=torch.float32, gen=gen)
    return x, dt, A, Bm, Cm, D


def check_ssd(ssd, ref, gen) -> dict:
    Bz, S, H, P, G, N, Q = TENANTS, PROMPT, 32, 64, 1, 128, 128    # mamba2-370m prefill
    cases = [(2, 128, 2, 32, 1, 16, 32), (2, 256, 4, 64, 2, 32, 64),
             (2, 64, 2, 16, 1, 64, 64),                            # the reference's three
             (Bz, S, H, P, G, N, Q),                               # the path's shape
             (2, 100, 4, 16, 1, 16, 32),                           # ragged S
             # the tensor-core kernel's edges: more heads a group than a block
             # takes, a chunk of 12 (zero-filled to 32), N 8 and 96; then a
             # head dim it does not take (the first design)
             (2, 256, 8, 64, 1, 64, 64), (1, 12, 4, 16, 2, 8, 16), (2, 192, 6, 32, 2, 96, 64),
             (1, 128, 2, 128, 1, 32, 64)]
    worst, by_kernel = 0.0, {}
    for case in cases:
        b_, s_, h_, p_, g_, n_, q_ = case
        x, dt, A, Bm, Cm, D = _ssd_inputs(gen, b_, s_, h_, p_, g_, n_)
        h0 = randn(b_, h_, p_, n_, dtype=torch.float32, gen=gen, scale=0.3)
        kernel = ssd.kernel_for(p_, n_, min(q_, s_))
        y, hT = one_launch(f"ssd {case}", ssd, kernel,
                           lambda: ssd.ssd(x, dt, A, Bm, Cm, D=D, init_state=h0, chunk=q_))
        y_seq, h_seq = ref.ssd_ref(x, dt, A, Bm, Cm, D=D, init_state=h0)
        y_chk, h_chk = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D=D, init_state=h0,
                                           chunk=min(q_, s_))
        for label, want_y, want_h in (("ssd_ref", y_seq, h_seq), ("ssd_chunked_ref", y_chk, h_chk)):
            err = compare(f"ssd {case} [{kernel}] y vs {label}", y, want_y, SSD_TOL)
            compare(f"ssd {case} [{kernel}] state vs {label}", hT, want_h, SSD_TOL)
            if case == (Bz, S, H, P, G, N, Q):
                worst = max(worst, err)
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
    # prefill state chained into the sequential decode recurrence
    x, dt, A, Bm, Cm, _ = _ssd_inputs(gen, 1, 96, 2, 16, 1, 8)
    y_all, _ = ref.ssd_ref(x, dt, A, Bm, Cm)
    cut = 64
    _, h = one_launch("ssd chaining", ssd, ssd.kernel_for(16, 8, 32),
                      lambda: ssd.ssd(x[:, :cut], dt[:, :cut], A, Bm[:, :cut], Cm[:, :cut],
                                      chunk=32))
    ys = []
    for t in range(cut, 96):
        y_t, h = ref.ssd_ref(x[:, t:t + 1], dt[:, t:t + 1], A, Bm[:, t:t + 1],
                             Cm[:, t:t + 1], init_state=h)
        ys.append(y_t)
    compare("ssd state chaining", torch.cat(ys, 1), y_all[:, cut:], SSD_TOL)
    log(f"ssd: {len(cases) + 1} cases agree ({by_kernel}; path-shape max abs err {worst:.3g})")

    # the kernels alone, at the path's shape, from ssd()'s own layouts
    x, dt, A, Bm, Cm, _ = _ssd_inputs(gen, Bz, S, H, P, G, N)
    xs = ssd._rows_first(x * dt[..., None])
    bg, cg = ssd._rows_first(Bm), ssd._rows_first(Cm)
    lda = ssd._rows_first(dt * A)
    want = ref.ssd_intra_chunk_ref(xs, bg, cg, lda, Q)
    new = ssd.KERNELS[0]
    smem_fn = ssd._build.library(new).ssd_chunk_sm90_smem_bytes
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int], ctypes.c_size_t
    for n_ in (8, 96, N):   # the wrapper states the launcher's sum
        launcher, wrapper = smem_fn(n_), ssd.smem_bytes(Q, P, n_, new)
        if launcher != wrapper:
            raise AssertionError(f"ssd smem_bytes(N {n_}): launcher {launcher}, "
                                 f"wrapper {wrapper}")
    got = ssd.launch_kernel(new, xs, bg, cg, lda, Q)
    for name, g_, w_ in zip(("y", "state", "cdecay"), got, want):
        compare(f"ssd_intra_chunk {new} {name}", g_, w_, SSD_TOL)
    # f32 accuracy on the tensor cores: the split's terms must all be there
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = ref.ssd_intra_chunk_ref(xs, bg, cg, lda, Q)   # single-pass TF32
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rel = {}
    for name, i in (("y", 0), ("state", 1)):
        rel[name] = (rel_l2(got[i], want[i]), rel_l2(control[i], want[i]))
        if not rel[name][0] <= SSD_REL < rel[name][1]:
            raise AssertionError(f"ssd_intra_chunk {new} {name}: relative L2 {rel[name][0]:.3g} "
                                 f"(single-pass TF32 {rel[name][1]:.3g}) against {SSD_REL}")
    log(f"ssd_intra_chunk {new} relative L2 of the f32 plain version (limit {SSD_REL}): "
        + "; ".join(f"{k} {a:.3g} (single-pass TF32 {b:.3g})" for k, (a, b) in rel.items()))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: ssd.ssd_intra_chunk(xs, bg, cg, lda, Q), flush=flush)
    first_ms = time_ms(lambda: ssd.launch_kernel("ssd_chunk", xs, bg, cg, lda, Q), flush=flush)
    plain_ms = time_ms(lambda: ref.ssd_intra_chunk_ref(xs, bg, cg, lda, Q), flush=flush)
    BH, nc = Bz * H, S // Q
    pairs = nc * Q * (Q + 1) // 2                # causal (i, j) pairs of a chunk
    # C·Bᵀ once per group, y per head, end-state per head
    flops = 2 * pairs * (Bz * G * N + BH * P) + 2 * BH * nc * Q * N * P
    nbytes = 4 * (2 * xs.numel() + bg.numel() + cg.numel() + lda.numel()
                  + BH * nc * (N * P + 1))
    f32_ms, f32_by = bound(nbytes, flops, torch.float32)
    b_ms, b_by = bound(nbytes, 3 * flops, "tf32")   # three TF32 products each (3xTF32)
    log(f"ssd_intra_chunk timing (BH {BH}, S {S}, Q {Q}, P {P}, N {N} f32; first design "
        f"through its raw launcher):")
    log(f"  kernel {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s of f32 work, "
        f"{b_ms / kernel_ms:.1%} of the {b_by} bound {b_ms:.4f} ms: {nbytes / 1e6:.1f} MB, "
        f"{3 * flops / 1e9:.2f} GFLOP of TF32 at 495 TFLOP/s)")
    log(f"  first design {first_ms:.4f} ms ({flops / first_ms / 1e9:.1f} TFLOP/s; its "
        f"{f32_by} bound on the f32 CUDA cores {f32_ms:.4f} ms); new / first "
        f"{kernel_ms / first_ms:.3f}; plain {plain_ms:.4f} ms")
    e = entry("ssd_intra_chunk", "ssd_chunk_sm90.cu", "src/repro/kernels/ssd_scan.py:69",
              worst, SSD_TOL, kernel_ms, plain_ms, None, b_ms, b_by, [BH, S, Q, P, N], "float32")
    e.update(first_design_ms=first_ms, f32_core_bound_ms=f32_ms,
             rel_l2={k: {"kernel": a, "single_pass_tf32": b} for k, (a, b) in rel.items()},
             rel_l2_limit=SSD_REL)
    return e


# ---------------------------------------------------------------- paths

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
    groups = {"flash_attention kernel": ("fa_sm90", "fa_fwd"),   # before cuBLAS's "sm90"
              "rmsnorm_sm90 kernel": ("rmsnorm_sm90",),
              "rmsnorm kernel (first design)": ("rmsnorm_kernel",),
              "grouped_matmul kernel": ("gmm_sm90", "gmm_bf16", "gmm_f32"),
              "ssd_chunk_sm90 kernel": ("ssd_chunk_sm90",),
              "ssd kernel (first design)": ("ssd_chunk_kernel",),
              "matmul (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass", "sm90")}
    other = "other (casts, elementwise, softmax, copies)"
    shares = {g: 0.0 for g in groups}
    shares[other] = 0.0
    for name, us in by_name.items():
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)), other)
        shares[g] += us
    log(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall_us:.1%}; idle {1 - busy / wall_us:.1%}), {n} device ops; "
        + "; ".join(f"{g} {us / 1e3:.2f} ms" for g, us in shares.items() if us))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        log(f"  {us / 1e3:8.2f} ms  {name[:100]}")


def read_counts(kernels: dict) -> dict:
    """Launch counts since the last reset, by kernel source
    (``csrc/<name>.cu``): a wrapper with several kernels counts each."""
    out = {}
    for name, mod in kernels.items():
        out.update(getattr(mod, "launches_by_kernel", {name: mod.launches}))
    return out


def serve_path(label: str, cfg, params, kernels: dict) -> dict:
    """One model's main path: 4 tenants prefill, then decode through the
    ``RegionServer`` from 4 threads. Every kernel's count is set to 0 just
    before and read just after (split into prefill and decode); then one
    profiled prefill and decode round. Checks what every path must show."""
    from repro_torch.core import TDG
    from repro_torch.core import lower
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import model as M
    from repro_torch.serving import RegionServer
    from repro_torch.training import make_serve_step

    max_len = PROMPT + DECODE_STEPS + 1
    prompts = [prompt_tokens(cfg, BATCH, PROMPT, 1 + i, "cuda") for i in range(TENANTS)]
    decode = make_serve_step(cfg)
    lower.clear_intern_cache()

    # ---- main path: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
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
    in_prefill = read_counts(kernels)

    server = RegionServer(max_batch=TENANTS, max_wait_ms=5.0, name=f"chip-smoke-{label}")
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
        total = read_counts(kernels)
        # ---- end of the main path
        stats = server.stats()
        if errors:
            raise errors[0]

        device_profile(f"{label} prefill (1 tenant, {BATCH}x{PROMPT})",
                       lambda: M.prefill(params, cfg, {"tokens": prompts[0]}, max_len))

        def decode_round():
            futures = [server.submit(f"tenant{i}", {
                "params": params, "tokens": st["tok"][:, None], "pos": st["pos"],
                "caches": st["caches"]}) for i, st in enumerate(states)]
            for fut in futures:
                fut.result(timeout=600)

        device_profile(f"{label} decode round ({TENANTS} tenants x batch {BATCH})",
                       decode_round)
    finally:
        server.close()

    m = stats["metrics"]
    toks = TENANTS * BATCH * DECODE_STEPS
    in_decode = {k: total[k] - in_prefill[k] for k in total}
    log(f"{label} prefill: {sum(prefill_ms):.1f} ms for {TENANTS} tenants x {BATCH}x{PROMPT} "
        f"(per tenant {', '.join(f'{x:.1f}' for x in prefill_ms)} ms)")
    log(f"{label} decode:  {t_decode * 1e3:.1f} ms for {DECODE_STEPS} steps x {TENANTS} "
        f"tenants ({toks / t_decode:.1f} tok/s)")
    log(f"{label} server:  {m['batches']} batches, occupancy mean "
        f"{m['batch_occupancy_mean']:.2f} max {m['batch_occupancy_max']}, "
        f"{m['batch_fallbacks']} fallbacks, queue peak {m['queue_depth_peak']}; "
        f"pool {stats['pool']}; intern {stats['intern']}")
    log(f"{label} latency: p50 {m['latency']['p50_s'] * 1e3:.2f} ms  p99 "
        f"{m['latency']['p99_s'] * 1e3:.2f} ms")
    log(f"{label} launches: " + "; ".join(f"{k} {in_prefill[k]} in prefill + {in_decode[k]} "
                                          f"in decode" for k in total))
    for first in FIRST_DESIGNS:
        if total[first]:
            raise AssertionError(f"{label}: the first design {first} launched {total[first]} "
                                 f"times on the main path")

    if m["batch_fallbacks"] != 0:
        raise AssertionError(f"{label}: {m['batch_fallbacks']} batches fell back to serial replay")
    if not m["batch_occupancy_max"] > 1:
        raise AssertionError(f"{label}: no decode batch coalesced more than one tenant")
    if stats["intern"]["hits"] < TENANTS - 1:
        raise AssertionError(f"{label}: intern hits {stats['intern']['hits']} < {TENANTS - 1}")
    if m["completed"] != TENANTS * DECODE_STEPS or m["failed"]:
        raise AssertionError(f"{label}: completed {m['completed']}, failed {m['failed']}")
    for st in states:
        gen = torch.stack(st["out"], dim=1)
        if gen.shape != (BATCH, DECODE_STEPS + 1) or not (
                (gen >= 0) & (gen < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: bad generated tokens {gen.shape}")
    log(f"{label} tenant0 sample token ids:", torch.stack(states[0]["out"], 1)[0].tolist())
    return {"states": states, "prompts": prompts, "max_len": max_len,
            "prefill": in_prefill, "decode": in_decode}


def logits_gap(params, cfg, prompt, max_len, registry, first_tok,
               kernel_ctx=contextlib.nullcontext, plain_ctx=contextlib.nullcontext):
    """Tenant 0's prefill logits and one decode step, with the kernels and
    with the plain versions (each run inside its context): (prefill rel L2,
    max abs, decode rel L2, max abs)."""
    from repro_torch.models import model as M

    def run():
        logits, caches, pos = M.prefill(params, cfg, {"tokens": prompt}, max_len)
        dec, _ = M.decode_step(params, cfg, first_tok[:, None], pos, caches)
        return logits[..., :cfg.vocab_size], dec[..., :cfg.vocab_size]

    with torch.no_grad():
        with kernel_ctx():
            pre_k, dec_k = run()
        with plain_ctx(), registry.kernel_mode_scope("ref"):
            pre_r, dec_r = run()
    if not torch.isfinite(pre_k).all() or not torch.isfinite(dec_k).all():
        raise AssertionError(f"{cfg.name}: logits not finite")
    return (rel_l2(pre_k, pre_r), (pre_k - pre_r).abs().max().item(),
            rel_l2(dec_k, dec_r), (dec_k - dec_r).abs().max().item())


def check_gap(label: str, gap, limit: float) -> None:
    pre, pre_abs, dec, dec_abs = gap
    log(f"{label} logits kernels vs plain (tenant 0): prefill rel L2 {pre:.3g} (max abs "
        f"{pre_abs:.3g}), decode step rel L2 {dec:.3g} (max abs {dec_abs:.3g}); limit {limit}")
    if not (pre <= limit and dec <= limit):
        raise AssertionError(f"{label}: kernel and plain logits differ by more than "
                             f"rel L2 {limit}")


def init_model(cfg):
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {nparams / 1e9:.3f}B "
        f"params f32, initialized in {time.perf_counter() - t0:.1f} s")
    return params


def need_both(run: dict, kernel: str) -> None:
    if not (run["prefill"][kernel] > 0 and run["decode"][kernel] > 0):
        raise AssertionError(f"{kernel} did not launch in both prefill and decode")


def run_dense(kernels, registry) -> dict:
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-3b")
    params = init_model(cfg)
    run = serve_path("dense", cfg, params, kernels)
    if run["prefill"]["flash_attention_sm90"] != TENANTS * cfg.num_layers:
        raise AssertionError(f"flash attention (TMA + wgmma) launched "
                             f"{run['prefill']['flash_attention_sm90']} times in prefill, not "
                             f"{cfg.num_layers} a tenant")
    need_both(run, "rmsnorm_sm90")
    gap = logits_gap(params, cfg, run["prompts"][0], run["max_len"], registry,
                     run["states"][0]["out"][0])
    check_gap("dense", gap, 2e-2)
    return run


@contextlib.contextmanager
def recorded_routing(out: list):
    """Record each MoE layer's top-k expert ids, in call order."""
    from repro_torch.models import moe

    orig = moe.route

    def recording(p, cfg, xt):
        r = orig(p, cfg, xt)
        out.append(r[2])
        return r

    moe.route = recording
    try:
        yield
    finally:
        moe.route = orig


@contextlib.contextmanager
def pinned_routing(recorded: list, own: list):
    """Make each MoE layer take the recorded top-k expert ids (in call
    order), with gates from its own probabilities; ``own`` gets the ids its
    own router would have picked."""
    from repro_torch.models import moe

    orig = moe.route
    ids = iter(recorded)

    def pinned(p, cfg, xt):
        probs, _, own_idx = orig(p, cfg, xt)
        own.append(own_idx)
        idx = next(ids)
        g = probs.gather(1, idx)
        return probs, g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), idx

    moe.route = pinned
    try:
        yield
    finally:
        moe.route = orig


def routing_diff(a: list, b: list) -> tuple[int, int]:
    """(top-k choices that differ, total choices) between two recorded runs."""
    diff = total = 0
    for ea, eb in zip(a, b):
        same = (ea[:, :, None] == eb[:, None, :]).any(-1).sum().item()
        diff += ea.numel() - same
        total += ea.numel()
    return diff, total


def run_moe(kernels, registry) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=MOE_LAYERS)
    params = init_model(cfg)
    run = serve_path("moe", cfg, params, kernels)
    per_tenant = 3 * cfg.num_layers
    if run["prefill"]["grouped_matmul_sm90"] != TENANTS * per_tenant:
        raise AssertionError(f"grouped matmul (TMA + wgmma) launched "
                             f"{run['prefill']['grouped_matmul_sm90']} times in prefill, not "
                             f"{per_tenant} a tenant")
    if not run["decode"]["grouped_matmul_sm90"] > 0:
        raise AssertionError("grouped matmul kernel never launched in decode")
    if run["prefill"]["flash_attention_sm90"] != TENANTS * cfg.num_layers:
        raise AssertionError(f"flash attention (TMA + wgmma) launched "
                             f"{run['prefill']['flash_attention_sm90']} times in MoE prefill, "
                             f"not {cfg.num_layers} a tenant")
    need_both(run, "rmsnorm_sm90")

    prompt, first = run["prompts"][0], run["states"][0]["out"][0]
    n = cfg.num_layers
    # (a) f32, same weights: the kernels against the plain versions, the
    # plain run pinned to the kernel run's expert choices (near-tied top-8
    # choices flip even in f32, and one flip moves a decode step's logits
    # by ~1%: unpinned, that would test the router's ties, not the kernels)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    routes, own = [], []   # kernel run's ids (prefill, decode); plain run's own
    gap = logits_gap(params, cfg32, prompt, run["max_len"], registry, first,
                     kernel_ctx=lambda: recorded_routing(routes),
                     plain_ctx=lambda: pinned_routing(routes, own))
    for step, at in (("prefill", 0), ("decode step", n)):
        diff, total = routing_diff(routes[at:at + n], own[at:at + n])
        log(f"moe f32 {step}: the plain run's own router would pick {diff} of {total} "
            f"top-{cfg.top_k} expert choices differently (pinned to the kernel run's)")
    check_gap("moe f32", gap, 1e-3)
    # (b) bf16, layer 0's MoE on one input; the router is a plain product of
    # identical inputs in both runs, so the routing is identical
    h = randn(BATCH, PROMPT, cfg.d_model, dtype=torch.bfloat16,
              gen=torch.Generator("cuda").manual_seed(7))
    layer0 = params.layers[0].moe
    with torch.no_grad():
        out_k, aux_k = moe.moe_apply(layer0, cfg, h)
        with registry.kernel_mode_scope("ref"):
            out_r, aux_r = moe.moe_apply(layer0, cfg, h)
    layer_err = rel_l2(out_k, out_r)
    log(f"moe bf16 layer 0: rel L2 {layer_err:.3g} (max abs "
        f"{(out_k.float() - out_r.float()).abs().max().item():.3g}), aux {aux_k.item():.6g} "
        f"vs {aux_r.item():.6g}; limit 2e-2")
    if not (layer_err <= 2e-2 and torch.isfinite(out_k.float()).all()):
        raise AssertionError("moe bf16 layer 0: kernels and plain versions disagree")
    # (c) bf16 whole model, unpinned: printed, no limit
    routes, own = [], []
    pre, _, dec, _ = logits_gap(params, cfg, prompt, run["max_len"], registry, first,
                                kernel_ctx=lambda: recorded_routing(routes),
                                plain_ctx=lambda: recorded_routing(own))
    diff, total = routing_diff(routes[:n], own[:n])
    log(f"moe bf16 whole model (unpinned, no limit): prefill logits rel L2 {pre:.3g}, "
        f"decode step {dec:.3g}; {diff} of {total} prefill expert choices differ")
    return run


def run_mamba(kernels, registry) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("mamba2-370m")
    params = init_model(cfg)
    run = serve_path("mamba2", cfg, params, kernels)
    if run["prefill"]["ssd_chunk_sm90"] != TENANTS * cfg.num_layers:
        raise AssertionError(f"SSD (tensor cores) launched {run['prefill']['ssd_chunk_sm90']} "
                             f"times in prefill, not {cfg.num_layers} a tenant")
    if run["decode"]["ssd_chunk_sm90"] != 0:
        raise AssertionError("SSD kernel launched in decode (the recurrence runs there)")
    need_both(run, "rmsnorm_sm90")
    prompt, first = run["prompts"][0], run["states"][0]["out"][0]
    # (a) f32, same weights: the kernels against the plain versions
    check_gap("mamba2 f32", logits_gap(params, dataclasses.replace(cfg, dtype="float32"),
                                       prompt, run["max_len"], registry, first), 1e-3)
    # (b) bf16, layer 0's mixer on one input, from a zero state (the SSD path)
    h = randn(BATCH, PROMPT, cfg.d_model, dtype=torch.bfloat16,
              gen=torch.Generator("cuda").manual_seed(7))
    state = ssm.init_ssm_state(cfg, BATCH, "cuda")
    with torch.no_grad():
        out_k, st_k = ssm.ssm_apply(params.layers[0].ssm, cfg, h, state)
        with registry.kernel_mode_scope("ref"):
            out_r, st_r = ssm.ssm_apply(params.layers[0].ssm, cfg, h, state)
    layer_err, state_err = rel_l2(out_k, out_r), rel_l2(st_k["ssd"], st_r["ssd"])
    log(f"mamba2 bf16 layer 0: output rel L2 {layer_err:.3g}, SSD state rel L2 "
        f"{state_err:.3g}; limit 2e-2")
    if not (layer_err <= 2e-2 and state_err <= 2e-2 and torch.isfinite(out_k.float()).all()):
        raise AssertionError("mamba2 bf16 layer 0: kernels and plain versions disagree")
    # (c) bf16 whole model, and its first 3, 12 and 24 layers: printed, no
    # limit (one-ulp differences grow with depth through the random-weight stack)
    layers, gaps = params.layers, []
    try:
        for depth in (3, 12, 24, cfg.num_layers):
            params.layers = torch.nn.ModuleList(list(layers)[:depth])
            pre, _, dec, _ = logits_gap(params, dataclasses.replace(cfg, num_layers=depth),
                                        prompt, run["max_len"], registry, first)
            gaps.append(f"{depth} layers {pre:.3g} / {dec:.3g}")
    finally:
        params.layers = layers
    log(f"mamba2 bf16 logits rel L2 by depth, prefill / decode step (no limit): "
        + ", ".join(gaps))
    return run


# ---------------------------------------------------------------- taskgraph

# (workload, sizes, grains, agreement): the paper's workloads at sizes the
# card does real work at. Captured replay, uncaptured replay and eager must
# agree within ``agreement`` x the largest magnitude among the outputs.
TASKGRAPH_RUNS = (
    ("cholesky", {"n": 16384}, (16, 32), 1e-5),
    ("heat", {"n": 16384, "iters": 2}, (16, 64), 1e-6),
    ("nbody", {"n_particles": 16384}, (16,), 1e-5),
    ("axpy", {"n": 1 << 28}, (16, 1024), 1e-6),
    ("dotp", {"n": 1 << 28}, (16, 1024), 1e-4),
    ("rmsnorm", {"n_tokens": 65536, "d": 2048, "depth": 2, "dtype": torch.bfloat16},
     (16, 256), TOL[torch.bfloat16]),
    ("attention", {"n_seqs": 64, "seq": 2048, "heads": 16, "head_dim": 128,
                   "dtype": torch.bfloat16}, (16,), TOL[torch.bfloat16]),
    ("attention", {"n_seqs": 16, "seq": 128, "heads": 4, "head_dim": 64}, (4,),
     TOL[torch.float32]),
)
# kernels each kernel workload must launch inside its captured graph, and
# the name prefix of each in a profiler trace
GRAPH_KERNELS = {("rmsnorm", torch.bfloat16): ("rmsnorm_sm90", "rmsnorm_sm90_kernel"),
                 ("attention", torch.bfloat16): ("flash_attention_sm90", "fa_sm90_kernel"),
                 ("attention", torch.float32): ("flash_attention", "fa_fwd_kernel")}
REPS = 5


def _median_ms(fn, reps: int = REPS):
    """Median host time of ``fn()`` over ``reps`` calls, each ending in a
    synchronize, and the last call's result."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _agree(label: str, got: dict, want: dict, rel: float) -> float:
    """The largest difference over all outputs, as a share of the largest
    magnitude among them (a reduction's partial near 0 is held to the scale
    of the sums, not to itself), must stay within ``rel``; the share."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: output slots differ")
    diff = scale = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or not torch.isfinite(g.float()).all():
            raise AssertionError(f"{label} {k}: shape {tuple(g.shape)} / {tuple(w.shape)} "
                                 f"or not finite")
        diff = max(diff, (g.float() - w.float()).abs().max().item())
        scale = max(scale, w.float().abs().max().item())
    worst = diff / max(scale, 1e-30)
    if worst > rel:
        raise AssertionError(f"{label}: differs by {worst:.3g} of the largest magnitude "
                             f"(limit {rel})")
    return worst


def _graph_kernel_names(fn) -> set[str]:
    """Names of the device kernels a profiler trace of ``fn()`` records.

    A trace that recorded no device activity at all (after many profiler
    sessions in one process, the profiler has returned empty traces of
    sub-millisecond runs) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        if names:
            break
    return names


def taskgraph_run(name: str, sizes: dict, nb: int, rel: float, kernels: dict,
                  card: str) -> dict:
    """One workload at one grain: record, captured replay (ReplayExecutor),
    uncaptured fused replay (lower_tdg(jit=False)), EagerExecutor(4); the
    workload's verify on the captured replay; the three must agree."""
    from repro_torch import workloads as W
    from repro_torch.core import EagerExecutor, ReplayExecutor, buffers_signature, lower_tdg

    dtype = sizes.get("dtype", torch.float32)
    label = f"{name}[{nb}] {str(dtype).replace('torch.', '')}"
    tdg, bufs, verify = W.WORKLOADS[name](**sizes, nb=nb, device="cuda")
    region = W.as_region(tdg, name=label)
    rec_ms, rec_out = _median_ms(lambda: region(**bufs), reps=1)

    replay = ReplayExecutor(region.tdg)
    keying_ms, _ = _median_ms(lambda: buffers_signature(bufs))   # host: the replay's cache key
    before = read_counts(kernels)
    capture_ms, _ = _median_ms(lambda: replay.run(bufs), reps=1)   # warm-up + capture
    at_capture = read_counts(kernels)
    cap_ms, cap_out = _median_ms(lambda: replay.run(bufs))
    after_replays = read_counts(kernels)

    uncaptured = lower_tdg(region.tdg, jit=False)
    unc_first_ms, _ = _median_ms(lambda: uncaptured(dict(bufs)), reps=1)
    per_replay = read_counts(kernels)
    unc_ms, unc_out = _median_ms(lambda: uncaptured(dict(bufs)))
    per_replay = {k: (v - per_replay[k]) // REPS for k, v in read_counts(kernels).items()}
    plan = uncaptured.last_plan.summary()

    eager = EagerExecutor(region.tdg, n_workers=4)
    eager_out = eager.run(dict(bufs))
    stats = dataclasses.replace(eager.stats)
    eager_ms, eager_out = _median_ms(lambda: eager.run(dict(bufs)))

    verify(cap_out)
    worst = max(_agree(f"{label} captured vs uncaptured", cap_out, unc_out, rel),
                _agree(f"{label} captured vs eager", cap_out, eager_out, rel),
                _agree(f"{label} record vs eager", rec_out, eager_out, rel))
    in_capture = {k: at_capture[k] - before[k] for k in before}
    in_replays = {k: after_replays[k] - at_capture[k] for k in before}
    if any(in_replays.values()):
        raise AssertionError(f"{label}: a wrapper counted launches during graph replays "
                             f"({in_replays})")
    # warm-up and capture each run the lowered region once
    if in_capture != {k: 2 * v for k, v in per_replay.items()}:
        raise AssertionError(f"{label}: launches during warm-up + capture {in_capture}, "
                             f"one uncaptured replay {per_replay}")
    captures = [fn.graph_replay.captures for fn in replay._cache.values()]
    if captures != [1]:
        raise AssertionError(f"{label}: {captures} captures, want one graph for one signature")
    graph_kernel = GRAPH_KERNELS.get((name, dtype))
    traced = None
    fallbacks = [c for c in plan["decisions"] if "fallback" in c["reason"]]
    if fallbacks:
        raise AssertionError(f"{label}: classes fell back to the unrolled form: {fallbacks}")
    if graph_kernel:
        kernel, symbol = graph_kernel
        for c in plan["decisions"]:
            if c["fused"] is not True or c["batcher"] != "vmap":
                raise AssertionError(f"{label}: class {c} is not fused by vmap")
        if not in_capture[kernel] > 0:
            raise AssertionError(f"{label}: {kernel} did not launch during the capture")
        names = _graph_kernel_names(lambda: [replay.run(bufs) for _ in range(3)])
        traced = sorted(n for n in names if symbol in n)
        if not traced:
            raise AssertionError(f"{label}: a trace of three replays shows no {symbol} "
                                 f"among {len(names)} device kernels: {sorted(names)[:12]}")
    stats_d = {k: v for k, v in stats.as_dict().items() if not k.endswith("seconds")}
    log(f"taskgraph {label}: {tdg.num_tasks} tasks, {plan['waves']} waves, "
        f"{plan['fused_classes']} fused classes ({plan['batchers']}); record "
        f"{rec_ms:.1f} ms, eager {eager_ms:.2f} ms (median of {REPS}), captured replay "
        f"{cap_ms:.2f} ms (capture {capture_ms:.1f} ms; its buffer signature alone "
        f"{keying_ms:.2f} ms of host time), uncaptured replay {unc_ms:.2f} ms "
        f"(first {unc_first_ms:.1f} ms); eager / captured {eager_ms / cap_ms:.2f}x, "
        f"uncaptured / captured {unc_ms / cap_ms:.2f}x; eager {stats_d}; agree within "
        f"{worst:.3g} (limit {rel}); launches in warm-up + capture "
        f"{ {k: v for k, v in in_capture.items() if v} }, in {REPS} replays 0"
        + (f"; traced {traced}" if traced else "") + f" ({card})")
    return {"workload": label, "tasks": tdg.num_tasks, "waves": plan["waves"],
            "fused_classes": plan["fused_classes"], "record_ms": rec_ms,
            "eager_ms": eager_ms, "captured_ms": cap_ms, "capture_ms": capture_ms,
            "signature_ms": keying_ms,
            "uncaptured_ms": unc_ms, "eager_stats": stats_d, "agreement": worst,
            "launches_in_capture": in_capture, "traced": traced}


def run_taskgraph(kernels: dict, card: str, runs=TASKGRAPH_RUNS) -> list:
    """The taskgraph phase: every workload at each grain, one at a time, its
    buffers and captured graphs freed before the next."""
    from repro_torch.core import lower, reset_registry

    out = []
    for name, sizes, grains, rel in runs:
        for nb in grains:
            torch.cuda.reset_peak_memory_stats()
            out.append(taskgraph_run(name, sizes, nb, rel, kernels, card))
            lower.clear_intern_cache()
            reset_registry()
            gc.collect()              # graphs and buffers held in cycles
            torch.cuda.empty_cache()
            log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"after freeing: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
                f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
            if torch.cuda.memory_reserved() > 8 << 30:
                raise AssertionError("the taskgraph phase left more than 8 GiB reserved "
                                     "after freeing a run")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import _build, ref, registry
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import moe_gmm as gmm
        from repro_torch.kernels import rmsnorm as rms
        from repro_torch.kernels import ssd_scan as ssd
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    card = smi()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    seconds = _build.build()
    log(f"build: {time.perf_counter() - t_start:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) or 'cached'})")
    for name in _build.SOURCES:   # ptxas -v: per-kernel registers and spills
        text = _build.log_path(name).read_text() if _build.log_path(name).exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
        smem = [int(s) for s in re.findall(r"(\d+) bytes smem", text)]
        if regs:
            log(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                f"spill stores up to {max(spills, default=0)} bytes, static shared memory "
                f"up to {max(smem, default=0)} bytes")

    gen = torch.Generator("cuda").manual_seed(1234)
    t0 = time.perf_counter()
    entries = [check_rmsnorm(rms, ref, gen), *check_attention(fa, ref, gen),
               check_grouped_matmul(gmm, ref, gen), check_ssd(ssd, ref, gen)]
    log(f"phase 2 (kernels) took {time.perf_counter() - t0:.1f} s")

    kernels = {"rmsnorm": rms, "flash_attention": fa, "grouped_matmul": gmm, "ssd": ssd}
    runs = {}
    for label, run_fn in (("dense", run_dense), ("moe", run_moe), ("mamba2", run_mamba)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = run_fn(kernels, registry)
        runs[label] = {k: run["prefill"][k] + run["decode"][k] for k in run["prefill"]}
        del run
        log(f"path {label}: {time.perf_counter() - t0:.1f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the taskgraph path: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    taskgraph = run_taskgraph(kernels, card)
    runs["taskgraph"] = read_counts(kernels)
    # ---- end of the taskgraph path
    log(f"path taskgraph: {len(taskgraph)} runs in {time.perf_counter() - t0:.1f} s; "
        f"launches {runs['taskgraph']}")

    for e in entries:
        src = Path(e["source"]).stem
        e["launches_by_path"] = {label: counts[src] for label, counts in runs.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        if not e["launches"] > 0:
            raise AssertionError(f"{e['name']} never launched on the main path")
    log(f"total {time.perf_counter() - t_start:.1f} s after the device check")
    log(json.dumps({"kernels": entries, "card": card}))
    log(json.dumps({"taskgraph": taskgraph, "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
