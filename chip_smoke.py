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
   of one 16-byte vector takes the register-resident kernel, with its
   edges: 16-lane rows, 2-8 warps a row, bf16 w, a partly filled lane, a
   grid tail, hymba's d 1600 and d 1000 and 16; odd d the first design)
   and flash attention (GQA, MQA, MHA, ragged S, window, chunk, decode
   offset, cross attention, head dims 16-128; head dim 64 / 128 takes the
   TMA + wgmma kernel, bf16 with its edges: decode-shaped, a window, Sk off
   its 128-key tile; f32 as 3xTF32 products at each mask and edge and at
   the dense prefill shape, where single-pass TF32's error is printed) at
   atol = rtol = 2e-5 in f32 and 2e-2 in bf16; grouped matmul (the reference's cases in f32 and bf16, ragged
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
   dense and MoE prefill shapes in bf16 and at the taskgraph's fused wave
   and the dense prefill shape in f32, grouped matmul at prefill and decode, SSD
   at the mamba2 shape and its bound both ways (f32 CUDA cores, and bytes
   against 3xTF32 tensor-core operations). Then each custom op's backward
   rule (a plain-torch function, ``kernels/ref.py``) at the training
   path's shapes: the kernel's forward plus the rule's backward through
   the public wrapper against the plain forward plus autograd, every
   gradient within TOL (f32 2e-5, bf16 2e-2) of its largest magnitude
   (RMSNorm (4, 512, 2048) bf16 with and without a residual and at d 1024;
   attention at the dense shape and in f32 with a window and a decode
   offset; grouped matmul at the MoE prefill shape; SSD at mamba2's); the
   rule alone is timed beside its bound and goes into the op's entry.
   Last, the kernels at the shapes the families phase (4) gives them first,
   each case one counted launch of the kernel ``kernel_for`` picks against
   the plain version, then timed beside the plain version, a library call
   and the bound, with an entry of its own: flash attention non-causal over
   whisper's 1500 frames (4 x 1500, 12/12 heads of 64), whisper's
   cross-attention (Sq 512 against Sk 1500) and hymba's GQA 5 (25/5 heads of
   64) under its 1024-token window at 4 x 2048 (prompts of 512 never reach
   the window); RMSNorm at hymba's d 1600 (2048 and 16 rows, bf16, beside
   the first design); grouped matmul at llama4's (16, 160, 5120) @ (16, 5120, 8192)
   bf16; SSD at hymba's 50 heads of 64, state 16, chunk 128.
3. Paths, one model at a time (the previous one freed first), two paths a
   model, each driven the same way: 4 tenants each prefill batch 4 x 512
   tokens, then 8 greedy decode steps each from 4 threads through the
   port's ``RegionServer`` (one-task decode TDGs, ``max_batch=4``,
   ``max_wait_ms=5``): first the request-level dispatcher
   (``continuous=False``), then the default server (continuous batching).
   Under both, every served step replays a CUDA graph (``capture=True``,
   the default). Kernel launch counts are set to 0 just before each path
   and read just after; a wrapper counts a launch in Python, so a kernel
   inside a graph counts at warm-up and capture, never at replay. Every
   path checks: no batch fell back to serial replay, some batch held more
   than one tenant, the structural intern cache was hit by tenants 2..4,
   a profiler trace of one more decode round (all graph replays) names
   each kernel the family runs in decode (``rmsnorm_sm90_kernel``, and
   ``gmm_sm90_kernel`` for MoE), and at most 8 GiB stay reserved beyond the
   params after the server is closed. The default server's path also
   prints its captures and their host time and the trace ring's summary,
   checks 0 < captures <= the (class, bucket) pairs its trace shows, and
   runs one fixed group of 4 (``autostart=False``) through a captured and
   an uncaptured server: the same tokens and caches. The first designs of
   all four kernels launch 0 times on every path (and, checked once all
   phases ran, on every path of every phase). After each model is
   freed, at most 8 GiB stay reserved.
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
   Each path ends with one more coalesced decode round under
   ``torch.profiler`` (and, request-level, one prefill), printing the
   card's busy and idle shares and the kernels that take the device time.
3m. The replay mesh, over 2 virtual shards on this card (a mesh of
   repeated ``cuda:0``: the card is one), each part with counts zeroed
   just before it and read just after: (a) with the dense path's weights,
   qwen2.5-3b served through ``RegionServer(mesh=...)``: 4 tenants prefill
   4 x 512 tokens, then 8 rounds of one 4-tenant step (``submit_many``),
   each step the bucket of 4 split into 2 shards that replay the captured
   2-tenant step; each round's inputs then go through a server without a
   mesh as 2 calls of 2 tenants (every token, f32 logit and cache bitwise
   equal) and as 1 call of 4 (logits within relative L2 2e-2, tokens equal
   but at ties, counted); 1 capture, flash attention 36 times a tenant in
   prefill, RMSNorm in prefill and decode; the step p50 sharded against
   unsharded. (b) the taskgraph phase's bf16 RMSNorm blocks (65,536 x 2048,
   depth 2) and attention blocks (64 x 2048 x 16 heads of 128), 16 blocks
   each, lowered over the mesh and captured: every output bitwise equal to
   ``mesh=None``'s captured replay, one capture, both kernels launched. (c)
   one qwen3-moe layer at full width (128 experts top-8, expert d_ff 768,
   bf16 compute) on 4 x 512 tokens, expert-parallel over a (1 data x 2
   model) mesh with its routing pinned to the global dispatch's: within
   relative L2 2e-2, ``grouped_matmul_sm90`` launched 3 times a shard.
4. Families: the reference's other seven models, one at a time (the
   previous one freed), f32 params from a seeded card generator, bf16
   compute, each through the default server exactly as a path of phase 3
   (4 tenants x 4 x 512 prompt tokens, 8 greedy decode steps, every step a
   graph replay, one fixed group captured against uncaptured; counts set
   to 0 just before and read just after): glm4-9b (40 layers), minicpm-2b
   (40), minitron-8b (32), chameleon-34b (12 of 48 layers: f32 params of 48
   take 137 GB), llama4-scout-17b-a16e (4 of 48; layer index 3 is its
   global-attention layer), hymba-1.5b (32) and whisper-small (12 encoder +
   12 decoder layers; each tenant's prefill takes seeded frames (4, 1500,
   768)), all at full width. The TMA + wgmma flash attention must launch
   once a layer a tenant in prefill (whisper: encoder, self- and
   cross-attention), the register-resident RMSNorm in prefill and decode on
   every model but whisper (LayerNorm, plain torch; hymba's d 1600 too),
   grouped matmul 3 times a layer in prefill and in decode on llama4, the
   tensor-core SSD once a layer in prefill and never in decode on hymba; no
   first design.
   Then (a) in f32 with the same weights, tenant 0's prefill logits and 3
   decode steps, kernels against plain within relative L2 1e-3 (llama4's
   plain run pinned to the kernel run's expert choices); (b) layer 0 in
   bf16 on one input within relative L2 2e-2 (whisper's with
   cross-attention to a (4, 1500, 768) encoder output; llama4 pinned); (c)
   the bf16 whole-model gap printed without limit. Each model prints its
   prefill ms, decode tok/s, p50 / p99, warm round, captures, peak memory
   and seconds.
4b. Cluster (``run_cluster``, ~200 s): full-width qwen2.5-3b with bf16
   params (6.17 GB, pinned once per worker in its register frame), 4
   tenants x batch 4 x prompt 512 prefilled here, then decode over RPC
   (``ClusterFrontend``, shm transport) from worker processes: one
   ``WorkerNode`` on a thread of this script (its counts and traces are
   this process's) and one spawned by ``LocalSpawner``. Counts are set to
   0 just before the prefill and read just after it, and again around the
   cluster serving; the in-process steps (b) and (e) are held to run
   between the two, uncounted. (b) a fixed group of 4 over the wire
   (the in-process worker's server started once all four landed): one step
   of occupancy 4, the same tokens as the in-process fixed group, caches
   bitwise equal or within bf16 2e-2; (c) a free run of 8 steps a tenant
   from 4 threads: every request completes, some coalesce; (a)
   ``ClusterFrontend.warmup`` exports the decode step on the card (the
   program must hold ``repro_torch::rmsnorm``) and the warm file ships it:
   the spawned worker registering 4 tenants from it hydrates (>= 1), never
   lowers (0 intern misses), counts no failure or reject and serves a
   single step with the program; (e) a ``REPRO_FAULT_PLAN`` armed for the
   spawned worker alone kills it at its 3rd ``submit_batch``: 1 death,
   requeues, the tenants re-ship TDG, pinned params and program to the
   sibling (which hydrates, no intern miss), every step is served, the slot
   is respawned; then each tenant serves tenant0's state alone where it is
   routed now, with the same tokens as the in-process step and caches
   within bf16 2e-2 (the failover run's own values are held to nothing:
   its batches form as requests come); (d) cold start, register -> first served step of one
   tenant on a fresh in-process worker, hydrated against re-lowered under
   ``REPRO_SHIP_ARTIFACTS=0`` (intern misses >= 1), printed without limit;
   the hydrated worker's second step, profiled, must replay
   ``rmsnorm_sm90_kernel`` inside the program's graph; (f) no worker process
   is left and at most 8 GiB stay reserved. A ``{"cluster": {...}}`` line
   holds the numbers.
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
   ``flash_attention_sm90`` in bf16 and, as ``fa_sm90_tf32_kernel``, in
   f32) must launch inside the captured graph: their counters rise by twice one
   uncaptured replay's launches at the first call (warm-up and capture),
   stay still over the replays, and a profiler trace of three replays shows
   the kernel's name. One line per run gives tasks, waves, fused classes,
   record, eager (median of 5), captured and uncaptured replay (median of
   5) times, and eager's ``ExecStats``. Launch counts are set to 0 just
   before the phase and read just after.
6. Training (f32 params, bf16 compute, batch 4 x 512, data from the
   reference's ``SyntheticLM`` with seed 0, weights from seed 0), one model
   at a time; launch counts set to 0 just before the phase and read just
   after (RMSNorm, flash attention and SSD must launch):
   a. the fused step (``make_train_step``: forward, backward through the
      rules, clipping, AdamW in place; ``remat="full"``) of qwen2.5-3b, 36
      layers, for 3 steps with the kernels, then 1 on the plain versions
      from the same weights: their first steps' loss and grad norm within
      2e-2; step ms (median of the last 2), tokens/s and peak memory;
      one more step under the profiler gives the card's idle share and the
      kernels that take its time;
   b. the same for mamba2-370m at 24 of 48 layers (the SSD forward kernel
      and rule; the launcher, d, trains it at full depth);
   c. the per-layer train region (``make_tdg_train_region``) of qwen2.5-3b
      at full width and 8 of 36 layers: record, ``EagerExecutor``,
      uncaptured and captured replay (median of 5 each); captured equal to
      uncaptured within 1e-6 of the largest magnitude, all equal to eager
      (loss 1e-5; params atol 1e-3, rtol 5e-3); 3 captured replays that pass
      the donated outputs back copy nothing, advance the optimizer step to
      3 on the card and capture once; a profiler trace of one replay shows
      backward kernels and the RMSNorm and attention kernels. The gap of
      the region's loss to the fused step's (the region's CE spans the
      unmasked pad columns, as the reference's does) is printed, and at
      vocabulary 152064 (a multiple of 256) the region is held to the fused
      step at the reference's tolerances (loss 1e-4; params atol 1e-3, rtol
      5e-3). AdamW runs at lr 1e-4 here: its first step moves each weight
      by about +-lr, so an entry whose bf16 gradient is near 0 may move
      either way in two orchestrations (2 lr), which stays inside atol;
   d. the launcher (``launch.train``'s ``run``, which ``main`` calls) on
      mamba2-370m for 20 steps at lr 1e-3 (at the default 3e-3 its loss
      rises; see LAUNCHER_LR), a checkpoint every 10: the loss must fall,
      and the step-20 checkpoint restored must equal the live state.
   At most 8 GiB may stay reserved after the phase.

7. Distributed (``run_distributed``), each drive's launch counts set to 0
   just before its main path and read just after ("pipeline", "mesh
   train"); every mesh is virtual (repeated positions of this card):
   a. pipeline: qwen2.5-3b at full width, its 36 blocks stacked into 4
      stages of 9 on ``ReplayMesh((4,), ("stage",), [cuda:0] * 4)``, 8
      microbatches of 1 x 512 tokens, f32 params, bf16 compute, remat; the
      embedding and the head (final norm, tied unembedding, CE) outside
      the pipeline. ``pipeline_apply``'s forward must be bitwise the stack
      applied microbatch by microbatch and within relative L2 2e-2 of the
      whole batch a stage; the loss and grad norm of its forward and
      backward within 2e-2 of the sequential run and of the same pipeline
      on the plain versions; 11 waves (``pipeline_waves(4, 8)``); the
      RMSNorm and flash-attention launches equal to the counts the code
      predicts (2 and 1 a block, again in each remat recompute, plus the
      final norm).
   b. training under a virtual 2 x 2 (data, model) mesh: qwen2.5-3b at
      full width and depth, batch 4 x 512 of SyntheticLM, 3 steps of
      ``make_train_step(mesh=...)``; step 1's loss and grad norm within
      2e-2 of the unsharded step and bitwise equal to the step written out
      chunk by chunk (params and moments too); step ms and peak memory
      beside the unsharded step's; launches as predicted; FlopCounterMode
      of one mesh step on the plain versions for (d).
   c. elastic: the same setup at 2 of 36 layers (its checkpoint of params
      and moments; all 36 layers' take 37 GB, some 100 s each way through
      the Checkpointer's npz and CRC-32): 3 steps on the 2 x 2 mesh with a
      checkpoint after step 2, restored as host arrays,
      ``reshard_checkpoint`` onto a virtual (1, 2) mesh, gathered whole and
      step 3 taken again: its loss within 2e-2 of the uninterrupted one.
   d. the dry-run, in a child process started before phase 5 (``meta``
      tensors only): (b)'s own cell on a 2 x 2 meta mesh must count the
      FLOPs FlopCounterMode counted in (b)'s plain step and place (b)'s
      bytes at each position; its roofline seconds beside (b)'s step;
      then qwen2.5-3b train_4k on the 16 x 16 meta production mesh, its
      record and wall time.
   At most 8 GiB may stay reserved after the phase.

In the ``{"kernels": [...]}`` line, ``launches_by_path`` holds each path's
counts of the entry's source (the bf16 and f32 attention kernels share
``flash_attention_sm90.cu`` and its count; the f32 entry adds
``launches_f32_taskgraph_capture``, the f32 attention runs' own launches)
and ``decode_round_replay_launches`` the launches of the kernel's symbol in
the profiled decode round's trace (graph replays, which the counts do not
see).

The last lines are one ``{"kernels": [...]}`` JSON object (with each op's
backward rule: ``backward_ms``, ``backward_bound_ms``, ...), one
``{"taskgraph": [...]}`` object, one ``{"training": {...}}`` object, one
``{"families": {...}}`` object, one ``{"cluster": {...}}`` object, one
``{"mesh": {...}}`` object, one ``{"distributed": {...}}`` object and then
``{"ok": true, "device": {...}}``.
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
# kept for the dtypes and shapes the Hopper designs do not take; no path
# launches them
FIRST_DESIGNS = ("flash_attention", "grouped_matmul", "rmsnorm", "ssd_chunk")
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
        # widths off the 16-vector tile take the register-resident kernel with
        # a lane's last vectors predicated: hymba's d 1600 (prefill, decode
        # with a residual, its f32 parity run), d 1000 and d 16 in bf16; odd d
        # takes the first design
        ((TENANTS * PROMPT, 1600), torch.bfloat16, torch.float32, False),
        ((TENANTS * BATCH, 1600), torch.bfloat16, torch.float32, True),
        ((64, 1600), torch.float32, torch.float32, True),
        ((33, 1000), torch.bfloat16, torch.bfloat16, True),
        ((5, 16), torch.bfloat16, torch.float32, False),
        ((7, 1001), torch.float32, torch.float32, False),
        ((7, 1001), torch.bfloat16, torch.float32, True),
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
        # the 3xTF32 kernel (f32 at head dim 64 / 128) at each mask and edge
        # beside the f32 cases above (its dense prefill shape below): GQA with
        # Sk off its 64-key tile, window, chunk, decode offset, cross attention
        (2, 100, 150, 8, 2, 128, torch.float32, {}),
        (1, 256, 256, 4, 2, 128, torch.float32, {"window": 100}),
        (1, 256, 256, 4, 2, 128, torch.float32, {"chunk": 64}),
        (2, 1, 128, 4, 2, 128, torch.float32, {"q_offset": 127}),
        (2, 64, 200, 4, 2, 128, torch.float32, {"causal": False}),
        (2, 100, 150, 8, 2, 64, torch.float32, {"q_offset": 37}),
        (2, 33, 77, 6, 3, 128, torch.float32, {"chunk": 16, "q_offset": 5}),
        (1, 96, 160, 8, 2, 64, torch.float32, {"window": 48, "q_offset": 64}),
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
        if Sq == PROMPT and dt == torch.bfloat16:
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

    # f32 (3xTF32): the taskgraph phase's fused wave of 16 sequences (the
    # reference's attention_blocks defaults) and the dense prefill shape,
    # where single-pass TF32 (the plain version's products under
    # allow_tf32) shows why three products are needed
    f32_shapes = {}
    log("flash_attention f32 (causal; first design through its raw launcher; bound: bytes "
        "against three TF32 products a MAC at 495 TFLOP/s):")
    for label, (B, S, Hq, Hkv, D) in (("taskgraph fused wave", (TG_F32_ATTN[0], TG_F32_ATTN[1],
                                                                 *TG_F32_ATTN[3:])),
                                      ("dense prefill", (TENANTS, PROMPT, 16, 2, 128))):
        q = randn(B, S, Hq, D, dtype=torch.float32, gen=gen)
        k, v = (randn(B, S, Hkv, D, dtype=torch.float32, gen=gen) for _ in range(2))
        want = ref.attention_ref(q, k, v)
        _, err = check_case(f"attention f32 {label}", fa, fa.kernel_for(torch.float32, D),
                            lambda: fa.flash_attention(q, k, v), want, TOL[torch.float32])
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            single = (ref.attention_ref(q, k, v) - want).abs().max().item()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        del want
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v), flush=flush)
        first_ms = time_ms(lambda: fa.launch_kernel("flash_attention", q, k, v, True, -1, 0,
                                                    D ** -0.5, 0), flush=flush)
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v), flush=flush)
        lib_ms = library_ms("F.scaled_dot_product_attention",
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, is_causal=True, enable_gqa=Hq != Hkv), flush)
        flops = 4 * D * B * Hq * S * (S + 1) // 2
        b_ms, b_by = bound(sum(t.numel() * t.element_size() for t in (q, k, v, q)), 3 * flops,
                           "tf32")
        design_line(f"{label} {B}x{S}, {Hq}/{Hkv} heads of {D}", kernel_ms, first_ms, "SDPA",
                    lib_ms, flops, b_ms, b_by)
        log(f"    max abs err {err:.3g} with 3xTF32 products, {single:.3g} single-pass TF32 "
            f"(limit {TOL[torch.float32]}); plain {plain_ms:.4f} ms")
        f32_shapes[label] = {"shape": [B, S, Hq, Hkv, D], "ms": kernel_ms,
                             "first_design_ms": first_ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "max_abs_err": err, "single_pass_tf32_max_abs_err": single}
        del q, k, v, qt, kt, vt
    tg = f32_shapes["taskgraph fused wave"]
    e_f32 = entry("flash_attention f32 (3xTF32)", "flash_attention_sm90.cu",
                  "src/repro/kernels/flash_attention.py:102", tg["max_abs_err"],
                  TOL[torch.float32], tg["ms"], tg["plain_ms"], tg["library_ms"], tg["bound_ms"],
                  tg["bound_by"], tg["shape"], "float32")
    e_f32.update(first_design_ms=tg["first_design_ms"], by_shape=f32_shapes)
    return e, e_f32


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


def _attention_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """(q, k) pairs one head of one sequence needs: all of them without
    causality, else key j <= query i (and i - j < window)."""
    if not causal:
        return Sq * Sk
    return sum(min(i + 1, window or i + 1) for i in range(Sq))


def check_new_shapes(rms, fa, gmm, ssd, ref, gen) -> list:
    """The four kernels at the shapes the families phase gives them first:
    non-causal attention over whisper's 1500 frames and its cross-attention
    (Sq 512, Sk 1500), hymba's GQA 5 under its 1024-token window (prompts of
    512 never reach the window), the register-resident RMSNorm at hymba's d
    1600 (prefill and decode rows, beside the first design),
    grouped matmul at llama4's 16 experts x 5120 -> 8192 (top-1, capacity
    160 at 2048 tokens) and the SSD intra-chunk kernel at hymba's 50 heads
    of 64, state 16. Each case: one counted launch of the kernel
    ``kernel_for`` picks, against the plain version at the phase's
    tolerances; then its time, the plain version's, one library call's and
    the bound. One entry each."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16
    out = []
    for label, (B, Sq, Sk, Hq, Hkv, D), kw in (
            ("whisper encoder", (TENANTS, 1500, 1500, 12, 12, 64), {"causal": False}),
            ("whisper cross", (TENANTS, PROMPT, 1500, 12, 12, 64), {"causal": False}),
            ("hymba window", (TENANTS, 2048, 2048, 25, 5, 64), {"window": 1024})):
        q = randn(B, Sq, Hq, D, dtype=bf16, gen=gen)
        k, v = (randn(B, Sk, Hkv, D, dtype=bf16, gen=gen) for _ in range(2))
        kernel = fa.kernel_for(bf16, D)
        _, err = check_case(f"attention {label} {(B, Sq, Sk, Hq, Hkv, D)} {kw}", fa, kernel,
                            lambda: fa.flash_attention(q, k, v, **kw),
                            ref.attention_ref(q, k, v, **kw), TOL[bf16])
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush=flush)
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, **kw), flush=flush)
        causal, window = kw.get("causal", True), kw.get("window")
        mask = None
        if window:   # SDPA takes the band as a boolean mask (True: attend)
            i = torch.arange(Sq, device="cuda")
            mask = (i[None] <= i[:, None]) & (i[:, None] - i[None] < window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = library_ms("F.scaled_dot_product_attention",
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv), flush)
        flops = 4 * D * B * Hq * _attention_pairs(Sq, Sk, causal, window)
        b_ms, b_by = bound(sum(t.numel() * t.element_size() for t in (q, k, v, q)), flops, bf16)
        log(f"flash_attention {label} {B}x{Sq} vs {Sk}, {Hq}/{Hkv} heads of {D} {kw} "
            f"[{kernel}]: agrees (max abs err {err:.3g}); kernel {kernel_ms:.4f} ms "
            f"({flops / kernel_ms / 1e9:.1f} TFLOP/s, {b_ms / kernel_ms:.1%} of the {b_by} "
            f"bound {b_ms:.4f} ms); plain {plain_ms:.4f} ms; SDPA {lib_ms} ms")
        e = entry(f"flash_attention @ {label}", f"{kernel}.cu",
                  "src/repro/kernels/flash_attention.py:102", err, TOL[bf16], kernel_ms,
                  plain_ms, lib_ms, b_ms, b_by, [B, Sq, Sk, Hq, Hkv, D], "bfloat16")
        e["masks"] = kw
        out.append(e)
        del q, k, v, qt, kt, vt

    d, by_shape = 1600, {}
    for label, n in (("prefill", TENANTS * PROMPT), ("decode", TENANTS * BATCH)):
        x, w = randn(n, d, dtype=bf16, gen=gen), randn(d, dtype=torch.float32, gen=gen)
        kernel = rms.kernel_for(bf16, d)
        if kernel != rms.KERNELS[0]:
            raise AssertionError(f"rmsnorm at d {d} picks {kernel}, not the register-resident "
                                 f"kernel")
        _, err = check_case(f"rmsnorm hymba {label} ({n}, {d}) bf16", rms, kernel,
                            lambda: rms.rmsnorm(x, w), ref.rmsnorm_ref(x, w), TOL[bf16])
        kernel_ms = time_ms(lambda: rms.rmsnorm(x, w), flush=flush)
        first_ms = time_ms(lambda: rms.launch_kernel("rmsnorm", x, w), flush=flush)
        plain_ms = time_ms(lambda: ref.rmsnorm_ref(x, w), flush=flush)
        lib_ms = library_ms("F.rms_norm", lambda: F.rms_norm(x, (d,), w, 1e-6), flush)
        b_ms, b_by = bound(2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
                           4 * x.numel(), torch.float32)
        log(f"rmsnorm hymba {label} ({n}, {d}) bf16 [{kernel}]: agrees (max abs err {err:.3g}); "
            f"kernel {kernel_ms:.4f} ms ({b_ms / kernel_ms:.1%} of the {b_by} bound "
            f"{b_ms:.4f} ms); first design {first_ms:.4f} ms ({b_ms / first_ms:.1%}); new / "
            f"first {kernel_ms / first_ms:.3f}; plain {plain_ms:.4f} ms; F.rms_norm {lib_ms} ms")
        by_shape[label] = {"shape": [n, d], "ms": kernel_ms, "first_design_ms": first_ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "max_abs_err": err}
    pre = by_shape["prefill"]
    e = entry("rmsnorm @ hymba d 1600", "rmsnorm_sm90.cu", "src/repro/kernels/rmsnorm.py:33",
              pre["max_abs_err"], TOL[bf16], pre["ms"], pre["plain_ms"], pre["library_ms"],
              pre["bound_ms"], pre["bound_by"], pre["shape"], "bfloat16")
    e.update(first_design_ms=pre["first_design_ms"], by_shape=by_shape)
    out.append(e)

    E, C, dd, ff = 16, 160, 5120, 8192
    x = randn(E, C, dd, dtype=bf16, gen=gen, scale=0.3)
    w = randn(E, dd, ff, dtype=bf16, gen=gen, scale=0.3)
    kernel = gmm.kernel_for(bf16, dd, ff)
    want = ref.grouped_matmul_ref(x, w)
    got, err = check_case(f"grouped_matmul llama4 {(E, C, dd, ff)}", gmm, kernel,
                          lambda: gmm.grouped_matmul(x, w), want, TOL[bf16] * dd, TOL[bf16])
    rl2 = rel_l2(got, want)
    if rl2 > GMM_REL[bf16]:
        raise AssertionError(f"grouped_matmul llama4: rel L2 {rl2:.3g} > {GMM_REL[bf16]}")
    del got, want
    kernel_ms = time_ms(lambda: gmm.grouped_matmul(x, w), flush=flush)
    plain_ms = time_ms(lambda: ref.grouped_matmul_ref(x, w), flush=flush)
    lib_ms = library_ms("torch.bmm", lambda: torch.bmm(x, w), flush)
    flops = 2 * E * C * dd * ff
    b_ms, b_by = bound(2 * (x.numel() + w.numel() + E * C * ff), flops, bf16)
    log(f"grouped_matmul llama4 {E}x{C}x{dd} @ {E}x{dd}x{ff} [{kernel}]: agrees (rel L2 "
        f"{rl2:.3g}); kernel {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / kernel_ms:.1%} of the {b_by} bound {b_ms:.4f} ms); plain {plain_ms:.4f} ms; "
        f"torch.bmm {lib_ms} ms")
    out.append(entry("grouped_matmul @ llama4", f"{kernel}.cu", "src/repro/kernels/moe_gmm.py:41",
                     err, TOL[bf16] * dd, kernel_ms, plain_ms, lib_ms, b_ms, b_by,
                     [E, C, dd, ff], "bfloat16"))
    del x, w

    Bz, S, H, P, G, N, Q = TENANTS, PROMPT, 50, 64, 1, 16, 128       # hymba prefill
    x, dt, A, Bm, Cm, D = _ssd_inputs(gen, Bz, S, H, P, G, N)
    kernel = ssd.kernel_for(P, N, Q)
    y, hT = one_launch(f"ssd hymba {(Bz, S, H, P, G, N, Q)}", ssd, kernel,
                       lambda: ssd.ssd(x, dt, A, Bm, Cm, D=D, chunk=Q))
    want_y, want_h = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D=D, chunk=Q)
    err = compare(f"ssd hymba [{kernel}] y", y, want_y, SSD_TOL)
    compare(f"ssd hymba [{kernel}] state", hT, want_h, SSD_TOL)
    xs = ssd._rows_first(x * dt[..., None])
    bg, cg, lda = ssd._rows_first(Bm), ssd._rows_first(Cm), ssd._rows_first(dt * A)
    kernel_ms = time_ms(lambda: ssd.ssd_intra_chunk(xs, bg, cg, lda, Q), flush=flush)
    plain_ms = time_ms(lambda: ref.ssd_intra_chunk_ref(xs, bg, cg, lda, Q), flush=flush)
    BH, nc = Bz * H, S // Q
    pairs = nc * Q * (Q + 1) // 2
    flops = 2 * pairs * (Bz * G * N + BH * P) + 2 * BH * nc * Q * N * P
    nbytes = 4 * (2 * xs.numel() + bg.numel() + cg.numel() + lda.numel()
                  + BH * nc * (N * P + 1))
    b_ms, b_by = bound(nbytes, 3 * flops, "tf32")
    log(f"ssd hymba (BH {BH}, S {S}, Q {Q}, P {P}, N {N}) [{kernel}]: agrees (max abs err "
        f"{err:.3g}); intra-chunk kernel {kernel_ms:.4f} ms ({b_ms / kernel_ms:.1%} of the "
        f"{b_by} bound {b_ms:.4f} ms); plain {plain_ms:.4f} ms; no library call")
    out.append(entry("ssd_intra_chunk @ hymba", f"{kernel}.cu", "src/repro/kernels/ssd_scan.py:69",
                     err, SSD_TOL, kernel_ms, plain_ms, None, b_ms, b_by, [BH, S, Q, P, N],
                     "float32"))
    return out


# ---------------------------------------------------------------- paths

def device_profile(label: str, fn, tries: int = 1) -> dict:
    """Run ``fn`` under torch.profiler; print its wall time, the card's busy
    and idle shares, and the kernels that took the device time. Returns the
    device kernels by name (launches, µs) and the idle share. A trace with
    no device activity (the profiler has returned such traces of short runs
    after many sessions in one process) is taken again, up to ``tries``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict[str, list] = {}
        for e in prof.events():
            # a record_function range (a program span) also shows on the
            # device's row as a user annotation over its kernels: not an op
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                row = by_name.setdefault(e.name, [0, 0.0])
                row[0] += 1
                row[1] += e.time_range.elapsed_us()
        if by_name:
            break
    n = sum(c for c, _ in by_name.values())
    busy = sum(us for _, us in by_name.values())
    if not busy:
        log(f"profile {label}: wall {wall_us / 1e3:.1f} ms; device time not measured "
            f"(the profiler recorded no CUDA activity)")
        return {"kernels": {}, "idle": None}
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
    for name, (_, us) in by_name.items():
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)), other)
        shares[g] += us
    log(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall_us:.1%}; idle {1 - busy / wall_us:.1%}), {n} device ops; "
        + "; ".join(f"{g} {us / 1e3:.2f} ms" for g, us in shares.items() if us))
    for name, (_, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]:
        log(f"  {us / 1e3:8.2f} ms  {name[:100]}")
    return {"kernels": {name: tuple(row) for name, row in by_name.items()},
            "idle": 1 - busy / wall_us}


def read_counts(kernels: dict) -> dict:
    """Launch counts since the last reset, by kernel source
    (``csrc/<name>.cu``): a wrapper with several kernels counts each."""
    out = {}
    for name, mod in kernels.items():
        out.update(getattr(mod, "launches_by_kernel", {name: mod.launches}))
    return out


# the kernels each family's decode step launches, by symbol in a profiler trace
# (whisper's decode step runs no hand-written kernel: LayerNorm, the cached
# self- and cross-attention are plain torch, as in the reference)
DECODE_SYMBOLS = {"dense": ("rmsnorm_sm90_kernel",), "moe": ("rmsnorm_sm90_kernel",
                  "gmm_sm90_kernel"), "mamba2": ("rmsnorm_sm90_kernel",),
                  "glm4-9b": ("rmsnorm_sm90_kernel",), "minicpm-2b": ("rmsnorm_sm90_kernel",),
                  "minitron-8b": ("rmsnorm_sm90_kernel",),
                  "chameleon-34b": ("rmsnorm_sm90_kernel",),
                  "llama4-scout-17b-a16e": ("rmsnorm_sm90_kernel", "gmm_sm90_kernel"),
                  "hymba-1.5b": ("rmsnorm_sm90_kernel",),
                  "whisper-small": ()}
RESERVED_LIMIT = 8 << 30


def _decode_request(params, st) -> dict:
    return {"params": params, "tokens": st["tok"][:, None], "pos": st["pos"],
            "caches": st["caches"]}


def _register_decoders(server, decode) -> None:
    from repro_torch.core import TDG

    for i in range(TENANTS):
        tdg = TDG(f"decode[{i}]")
        tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                     outs=["next", "caches"], name="decode")
        server.register_tenant(f"tenant{i}", tdg, outputs=("next", "caches"))


def serve_path(label: str, family: str, cfg, params, kernels: dict,
               continuous: bool | None) -> dict:
    """One model's main path: 4 tenants prefill, then decode through the
    ``RegionServer`` from 4 threads, request-level (``continuous=False``) or
    through the default server (continuous, every step a graph replay).
    Every kernel's count is set to 0 just before and read just after (split
    into prefill and decode); then a profiled decode round (and, for the
    request-level path, a profiled prefill). Checks what every path must
    show; the default server's path also its captures, the kernels its graph
    replays launch, and one fixed group captured against uncaptured. No
    first design may launch."""
    from repro_torch.core import lower
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import model as M
    from repro_torch.serving import RegionServer
    from repro_torch.training import make_serve_step

    max_len = PROMPT + DECODE_STEPS + 1
    # a tenant's prompt: token ids (and, for encdec, frames) from seed 1 + i
    prompts = [prompt_batch(cfg, BATCH, PROMPT, 1 + i, "cuda") for i in range(TENANTS)]
    decode = make_serve_step(cfg)
    lower.clear_intern_cache()

    # ---- main path: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    states, prefill_ms = [], []
    for i in range(TENANTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, pos = M.prefill(params, cfg, prompts[i], max_len)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        states.append({"tok": tok, "pos": pos, "caches": caches, "out": [tok],
                       "logits": logits})
    in_prefill = read_counts(kernels)
    del logits, caches, pos, tok   # the states hold them

    server = RegionServer(max_batch=TENANTS, max_wait_ms=5.0, name=f"chip-smoke-{label}",
                          continuous=continuous)
    errors: list[BaseException] = []
    try:
        _register_decoders(server, decode)

        def tenant_loop(i: int) -> None:
            try:
                st = states[i]
                for _ in range(DECODE_STEPS):
                    out = server.serve(f"tenant{i}", _decode_request(params, st),
                                       timeout=600)
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
        trace = server.metrics.trace.snapshot()
        if errors:
            raise errors[0]

        if not server.continuous:
            device_profile(f"{label} prefill (1 tenant, {BATCH}x{PROMPT})",
                           lambda: M.prefill(params, cfg, prompts[0], max_len))

        def decode_round():
            futures = server.submit_many([(f"tenant{i}", _decode_request(params, st))
                                          for i, st in enumerate(states)])
            for fut in futures:
                fut.result(timeout=600)

        decode_round()      # any bucket the main path did not see is captured here
        round_ms, _ = _median_ms(decode_round)
        profiled = device_profile(f"{label} decode round ({TENANTS} tenants x batch "
                                  f"{BATCH}, graph replays)", decode_round, tries=3)
        parts = step_parts(decode_round) if server.continuous else None
    finally:
        server.close()

    m = stats["metrics"]
    toks = TENANTS * BATCH * DECODE_STEPS
    in_decode = {k: total[k] - in_prefill[k] for k in total}
    graphs = stats["graphs"]
    log(f"{label} prefill: {sum(prefill_ms):.1f} ms for {TENANTS} tenants x {BATCH}x{PROMPT} "
        f"(per tenant {', '.join(f'{x:.1f}' for x in prefill_ms)} ms)")
    log(f"{label} decode:  {t_decode * 1e3:.1f} ms for {DECODE_STEPS} steps x {TENANTS} "
        f"tenants ({toks / t_decode:.1f} tok/s)")
    log(f"{label} server:  continuous={server.continuous}, {m['batches']} batches, occupancy "
        f"mean {m['batch_occupancy_mean']:.2f} max {m['batch_occupancy_max']}, "
        f"{m['batch_fallbacks']} fallbacks, queue peak {m['queue_depth_peak']}; "
        f"pool {stats['pool']}; intern {stats['intern']}; buckets "
        f"{stats['buckets']['boundaries']}")
    log(f"{label} latency: p50 {m['latency']['p50_s'] * 1e3:.2f} ms  p99 "
        f"{m['latency']['p99_s'] * 1e3:.2f} ms; graphs: {graphs['captures']} captures "
        f"({graphs['evictions']} evicted) in "
        f"{graphs['capture_ms']:.1f} ms; a warm decode round of {TENANTS} (median of "
        f"{REPS}) {round_ms:.2f} ms ({TENANTS * BATCH / round_ms * 1e3:.1f} tok/s)")
    if parts:
        log(f"{label} a captured step of {TENANTS}, mean host ms by span over two rounds: "
            + "; ".join(f"{k} {v:.3f}" for k, v in parts.items()))
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

    replayed = {sym: sum(c for name, (c, _) in profiled["kernels"].items() if sym in name)
                for sym in DECODE_SYMBOLS[family]}
    log(f"{label} decode-round graph replays launched (profiler trace): {replayed}; "
        f"card idle {profiled['idle']}")
    missing = [sym for sym, n in replayed.items() if not n]
    if missing:
        raise AssertionError(f"{label}: a trace of the decode round's replays shows no "
                             f"{missing} among {sorted(profiled['kernels'])[:12]}")
    if server.continuous:
        pairs = {(r["class_id"], r["bucket"]) for r in trace}
        log(f"{label} trace: {m['trace']}; (class, bucket) pairs {sorted(pairs)}; "
            f"occupancy by step {[r['occupancy'] for r in trace]}")
        if not 0 < graphs["captures"] <= len(pairs):
            raise AssertionError(f"{label}: {graphs['captures']} captures for {len(pairs)} "
                                 f"(class, bucket) pairs in the trace")
        fixed_group(label, decode, params, states)

    # the tenants' caches and logits end here, and the tokens callers read
    # are copied out of the served steps' packed outputs (views that would
    # keep each step's int32 output alive): what stays reserved beyond the
    # params after this is what the path failed to free (a live tensor of a
    # MiB or more pins the whole cached block it was carved from)
    served = [(st.pop("caches"), st.pop("logits"), st["out"]) for st in states]
    for st in states:
        st["out"] = [t.clone() for t in st["out"]]
        st["tok"] = st["out"][-1]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in torch.utils._pytree.tree_leaves(served)}
    cache_bytes = sum(storages.values())
    del server, served
    lower.clear_intern_cache()
    gc.collect()
    torch.cuda.empty_cache()
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    reserved = torch.cuda.memory_reserved()
    log(f"{label}: after the path {reserved / 2**30:.2f} GiB reserved, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, of which the params "
        f"{param_bytes / 2**30:.2f} GiB (the served caches, logits and step outputs, "
        f"{cache_bytes / 2**30:.2f} GiB of storage, freed)")
    if reserved - param_bytes > RESERVED_LIMIT / 2:
        segments = sorted(torch.cuda.memory_snapshot(),
                          key=lambda g: g["allocated_size"] - g["total_size"])
        for g in segments[:8]:
            log(f"  segment {g['total_size'] / 2**20:.0f} MiB, {g['allocated_size'] / 2**20:.0f} "
                f"MiB allocated, pool {g.get('segment_pool_id')}, blocks "
                f"{[(b['size'] >> 20, b['state']) for b in g['blocks']][:6]}")
    if reserved - param_bytes > RESERVED_LIMIT:
        raise AssertionError(f"{label}: more than 8 GiB reserved beyond the params after "
                             f"the path")
    return {"states": states, "prompts": prompts, "max_len": max_len,
            "prefill": in_prefill, "decode": in_decode, "replayed": replayed,
            "metrics": {"prefill_ms": prefill_ms, "decode_s": t_decode,
                        "decode_tok_s": toks / t_decode,
                        "p50_ms": m["latency"]["p50_s"] * 1e3,
                        "p99_ms": m["latency"]["p99_s"] * 1e3,
                        "warm_round_ms": round_ms, "captures": graphs["captures"],
                        "capture_ms": graphs["capture_ms"], "card_idle": profiled["idle"],
                        "step_host_ms": parts}}


def step_parts(decode_round) -> dict:
    """Mean host ms of a served step and of its parts (keying the graph,
    copying the inputs in, launching the graph, waiting for it, copying the
    packed outputs out and slicing them), from the program's spans over two
    decode rounds."""
    from repro_torch.core import spans

    spans.enable()
    try:
        decode_round()
        decode_round()
        recs = spans.snapshot()
    finally:
        spans.disable()
    parts = {}
    for name in ("replay.key", "replay.copy_in", "replay.launch", "step.wait",
                 "replay.copy_out", "step"):
        took = [r["t1"] - r["t0"] for r in recs if r["name"] == name]
        if took:
            parts[name] = 1e3 * sum(took) / len(took)
    return parts


def fixed_group(label: str, decode, params, states) -> None:
    """One fixed group of 4 (``autostart=False``: all 4 join the first step)
    through a captured and an uncaptured default server: the same tokens and
    caches."""
    from repro_torch.serving import RegionServer

    outs = {}
    for capture in (True, False):
        server = RegionServer(max_batch=TENANTS, max_wait_ms=5.0, autostart=False,
                              capture=capture, name=f"chip-smoke-{label}-fixed")
        _register_decoders(server, decode)
        futs = [server.submit(f"tenant{i}", _decode_request(params, st))
                for i, st in enumerate(states)]
        server.start()
        outs[capture] = [f.result(timeout=600) for f in futs]
        occupancy = [r["occupancy"] for r in server.metrics.trace.snapshot()]
        server.close()
        if occupancy != [TENANTS]:
            raise AssertionError(f"{label} fixed group: steps of {occupancy}, want one of "
                                 f"{TENANTS}")
    bitwise, gap = True, 0.0
    for a, b in zip(outs[True], outs[False]):
        if not torch.equal(a["next"], b["next"]):
            raise AssertionError(f"{label} fixed group: captured and uncaptured tokens differ")
        for x, y in zip(torch.utils._pytree.tree_leaves(a["caches"]),
                        torch.utils._pytree.tree_leaves(b["caches"])):
            bitwise &= torch.equal(x, y)
            gap = max(gap, (x.float() - y.float()).abs().max().item())
    log(f"{label} fixed group of {TENANTS}: captured == uncaptured tokens; caches "
        f"{'bitwise equal' if bitwise else f'max abs gap {gap:.3g} (limit bf16 2e-2)'}")
    if gap > TOL[torch.bfloat16]:
        raise AssertionError(f"{label} fixed group: caches differ by {gap:.3g}")


def logits_gap(params, cfg, prompt: dict, max_len, registry, step_toks: list,
               kernel_ctx=contextlib.nullcontext, plain_ctx=contextlib.nullcontext):
    """Tenant 0's prefill logits and a decode step for each of ``step_toks``
    (the same tokens in both runs), with the kernels and with the plain
    versions (each run inside its context): (prefill rel L2, max abs, decode
    rel L2, max abs), the decode steps' logits taken together."""
    from repro_torch.models import model as M

    def run():
        logits, caches, pos = M.prefill(params, cfg, prompt, max_len)
        decs = []
        for tok in step_toks:
            dec, caches = M.decode_step(params, cfg, tok[:, None], pos, caches)
            pos = pos + 1
            decs.append(dec)
        return logits[..., :cfg.vocab_size], torch.cat(decs, 1)[..., :cfg.vocab_size]

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
        f"{pre_abs:.3g}), decode steps rel L2 {dec:.3g} (max abs {dec_abs:.3g}); limit {limit}")
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
    runs = {}
    for label, continuous in (("dense", False), ("dense continuous", None)):
        run = runs[label] = serve_path(label, "dense", cfg, params, kernels, continuous)
        if run["prefill"]["flash_attention_sm90"] != TENANTS * cfg.num_layers:
            raise AssertionError(f"flash attention (TMA + wgmma) launched "
                                 f"{run['prefill']['flash_attention_sm90']} times in prefill, "
                                 f"not {cfg.num_layers} a tenant")
        need_both(run, "rmsnorm_sm90")
    gap = logits_gap(params, cfg, run["prompts"][0], run["max_len"], registry,
                     run["states"][0]["out"][:1])
    check_gap("dense", gap, 2e-2)
    runs["mesh serve"] = serve_mesh(cfg, params, kernels)
    return runs


# ---------------------------------------------------------------- the replay mesh

def _virtual_mesh(shape: tuple, names: tuple):
    """A mesh whose every position is this card (virtual shards): the
    counterpart of the reference's fake host devices on one machine."""
    from repro_torch.launch.mesh import ReplayMesh

    n = 1
    for size in shape:
        n *= size
    return ReplayMesh(shape, names, [torch.device("cuda", 0)] * n)


def _tree_equal(a, b) -> bool:
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _near_ties(label: str, a: dict, b: dict) -> int:
    """Rows whose greedy tokens differ between two steps' outputs (``next``,
    f32 ``logits`` of bf16 products): each must be a tie at the runs'
    precision, i.e. each run's logit for the other's token within the rows'
    largest logit difference of its own maximum. Returns how many differ."""
    rows = (a["next"] != b["next"]).nonzero().flatten().tolist()
    for r in rows:
        la, lb = a["logits"][r], b["logits"][r]
        d = (la - lb).abs().max().item()
        ta, tb = a["next"][r].item(), b["next"][r].item()
        if not (lb.max() - lb[ta] <= d and la.max() - la[tb] <= d):
            raise AssertionError(f"{label} row {r}: tokens {ta} / {tb} differ by more than a "
                                 f"tie (logits differ by {d:.3g})")
    return len(rows)


def serve_mesh(cfg, params, kernels: dict) -> dict:
    """Phase 3m (a): the dense model served through ``RegionServer(mesh=...)``
    over 2 virtual shards on this card. 4 tenants prefill 4 x 512 tokens,
    then 8 rounds, each one step of all 4 (``submit_many``): the bucket of 4
    splits into 2 shards of 2 tenants, each shard one replay of the
    captured 2-tenant step. Counts are zeroed just before the prefill and
    read just after the 8 rounds. Then each round's inputs go through a
    server without a mesh, twice: as 2 calls of 2 tenants (the shards' own
    occupancy: every token, logit and cache bitwise equal) and as 1 call of
    4 (a 4-tenant step's products run at another M: logits within relative
    L2 2e-2, and the same tokens but at ties, where the two runs' top
    logits are equal to within their difference; bf16 products give such
    ties often over a 152k vocabulary, and each is counted)."""
    from repro_torch.core import TDG, lower
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import model as M
    from repro_torch.serving import RegionServer

    max_len = PROMPT + DECODE_STEPS + 1
    prompts = [prompt_batch(cfg, BATCH, PROMPT, 1 + i, "cuda") for i in range(TENANTS)]

    def decode(params, tokens, pos, caches):
        logits, caches = M.decode_step(params, cfg, tokens, pos, caches)
        last = logits[:, -1]
        return torch.argmax(last, dim=-1).to(torch.int32), last, caches

    def server(mesh, name):
        srv = RegionServer(max_batch=TENANTS, max_wait_ms=5.0, name=name, mesh=mesh)
        for i in range(TENANTS):
            tdg = TDG(f"decode[{i}]")
            tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                         outs=["next", "logits", "caches"], name="decode")
            srv.register_tenant(f"tenant{i}", tdg, outputs=("next", "logits", "caches"))
        return srv

    def step(srv, states, tenants) -> tuple[list, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = srv.submit_many([(f"tenant{i}", _decode_request(params, states[i]))
                                for i in tenants])
        outs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t0) * 1e3

    lower.clear_intern_cache()
    mesh = _virtual_mesh((2,), ("data",))
    # ---- main path: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    states = []
    for i in range(TENANTS):
        logits, caches, pos = M.prefill(params, cfg, prompts[i], max_len)
        states.append({"tok": torch.argmax(logits[:, -1], dim=-1).to(torch.int32),
                       "pos": pos, "caches": caches})
    del logits, caches, pos
    in_prefill = read_counts(kernels)
    sharded = server(mesh, "chip-smoke-mesh")
    rounds, mesh_ms = [], []
    try:
        for _ in range(DECODE_STEPS):
            outs, ms = step(sharded, states, range(TENANTS))
            rounds.append((states, outs))
            mesh_ms.append(ms)
            states = [{"tok": o["next"], "pos": st["pos"] + 1, "caches": o["caches"]}
                      for st, o in zip(states, outs)]
        total = read_counts(kernels)
        # ---- end of the main path
        stats = sharded.stats()
        occupancy = [r["occupancy"] for r in sharded.metrics.trace.snapshot()]
    finally:
        sharded.close()
    in_decode = {k: total[k] - in_prefill[k] for k in total}

    plain = server(None, "chip-smoke-mesh-plain")
    two_ms, four_ms, gaps, ties = [], [], [], 0
    try:
        for r, (ins, outs) in enumerate(rounds):
            two, ms_a = step(plain, ins, (0, 1))
            two_b, ms_b = step(plain, ins, (2, 3))
            four, ms = step(plain, ins, range(TENANTS))
            two_ms.append(ms_a + ms_b)
            four_ms.append(ms)
            for i, (o, t, f) in enumerate(zip(outs, two + two_b, four)):
                if not _tree_equal(o, t):
                    raise AssertionError(f"mesh serve round {r} tenant {i}: the sharded step "
                                         f"differs from the unsharded step of 2 tenants")
                ties += _near_ties(f"mesh serve round {r} tenant {i}", o, f)
                if not torch.isfinite(o["logits"]).all():
                    raise AssertionError(f"mesh serve round {r}: logits not finite")
            v = cfg.vocab_size          # the pad columns' -1e30 left out
            gaps.append(rel_l2(torch.cat([o["logits"][:, :v] for o in outs]),
                               torch.cat([f["logits"][:, :v] for f in four])))
        plain_stats = plain.stats()
    finally:
        plain.close()
    gap = max(gaps)
    graphs = stats["graphs"]
    p50 = statistics.median(mesh_ms)
    log(f"mesh serve: {stats['mesh']}, steps of {occupancy}; {graphs['captures']} captures "
        f"({graphs['capture_ms']:.1f} ms); step p50 {p50:.2f} ms sharded (2 x 2 tenants), "
        f"{statistics.median(two_ms):.2f} ms unsharded as 2 calls of 2, "
        f"{statistics.median(four_ms):.2f} ms unsharded 1 call of 4; server p50 "
        f"{stats['metrics']['latency']['p50_s'] * 1e3:.2f} ms (unsharded server "
        f"{plain_stats['metrics']['latency']['p50_s'] * 1e3:.2f} ms)")
    log(f"mesh serve: every step bitwise equal to the unsharded steps of 2 tenants; tokens "
        f"equal to the unsharded steps of 4 but {ties} of "
        f"{DECODE_STEPS * TENANTS * BATCH} (each a tie at the two runs' precision); logits "
        f"rel L2 up to {gap:.3g} (limit 2e-2)")
    log(f"mesh serve launches: " + "; ".join(f"{k} {in_prefill[k]} in prefill + "
                                             f"{in_decode[k]} in decode" for k in total))
    if occupancy != [TENANTS] * DECODE_STEPS:
        raise AssertionError(f"mesh serve: steps of {occupancy}, want {DECODE_STEPS} of "
                             f"{TENANTS}")
    if stats["mesh"] != "data=2" or graphs["captures"] != 1:
        raise AssertionError(f"mesh serve: mesh {stats['mesh']}, {graphs['captures']} "
                             f"captures (want data=2 and one graph for both shards)")
    if gap > TOL[torch.bfloat16]:
        raise AssertionError(f"mesh serve: logits differ by rel L2 {gap:.3g}")
    if in_prefill["flash_attention_sm90"] != TENANTS * cfg.num_layers:
        raise AssertionError(f"mesh serve: flash attention launched "
                             f"{in_prefill['flash_attention_sm90']} times in prefill")
    if not (in_prefill["rmsnorm_sm90"] > 0 and in_decode["rmsnorm_sm90"] > 0):
        raise AssertionError("mesh serve: rmsnorm_sm90 did not launch in prefill and decode")
    del rounds, states
    lower.clear_intern_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill": in_prefill, "decode": in_decode, "replayed": {},
            "mesh": {"mesh": stats["mesh"], "captures": graphs["captures"],
                     "capture_ms": graphs["capture_ms"], "step_p50_ms": p50,
                     "unsharded_2x2_p50_ms": statistics.median(two_ms),
                     "unsharded_4_p50_ms": statistics.median(four_ms),
                     "logits_rel_l2": gap, "bitwise_vs_2_tenant_calls": True,
                     "tokens_tied_vs_4_tenant_call": ties,
                     "launches": {"prefill": in_prefill, "decode": in_decode}}}


MESH_WAVES = (("rmsnorm", {"n_tokens": 65536, "d": 2048, "depth": 2,
                           "dtype": torch.bfloat16}, 16),
              ("attention", {"n_seqs": 64, "seq": 2048, "heads": 16, "head_dim": 128,
                             "dtype": torch.bfloat16}, 16))


def mesh_waves(kernels: dict) -> dict:
    """Phase 3m (b): the taskgraph phase's bf16 RMSNorm and attention waves
    (16 blocks) lowered over 2 virtual shards (``lower_tdg(mesh=...)``,
    captured: one graph holds both shards' launches) against the same region
    lowered with ``mesh=None``, captured: every output bitwise equal. Counts
    are zeroed just before the sharded runs and read just after."""
    from repro_torch import workloads
    from repro_torch.core import lower, lower_tdg

    mesh = _virtual_mesh((2,), ("data",))
    cases = []
    for name, sizes, nb in MESH_WAVES:
        tdg, bufs, verify = workloads.WORKLOADS[name](**sizes, nb=nb, device="cuda")
        plain = lower_tdg(tdg, mesh=None, batcher="vmap")
        cases.append((name, tdg, bufs, verify, plain, plain(bufs)))
    # ---- main path: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    got = []
    for name, tdg, bufs, verify, plain, want in cases:
        sharded = lower_tdg(tdg, mesh=mesh, batcher="vmap")
        first = sharded(bufs)                         # warm-up and capture
        ms, again = _median_ms(lambda: sharded(bufs))
        got.append((sharded, first, again, ms))
    counts = read_counts(kernels)
    # ---- end of the main path
    out = {}
    for (name, tdg, bufs, verify, plain, want), (sharded, first, again, ms) in zip(cases, got):
        for label, o in (("first call", first), ("replay", again)):
            if set(o) != set(want) or not all(torch.equal(o[k], want[k]) for k in want):
                raise AssertionError(f"mesh waves {name}: the sharded {label} differs from "
                                     f"the unsharded replay")
        verify(again)
        plain_ms, _ = _median_ms(lambda: plain(bufs))
        captures = sharded.graph_replay.captures
        if captures != 1:
            raise AssertionError(f"mesh waves {name}: {captures} captures, want 1")
        out[name] = {"sharded_ms": ms, "unsharded_ms": plain_ms, "captures": captures,
                     "bitwise": True}
        log(f"mesh waves {name}[{len(tdg.tasks)} tasks, 2 shards]: bitwise equal to the "
            f"unsharded replay; captured replay {ms:.2f} ms sharded, {plain_ms:.2f} ms "
            f"unsharded (medians of {REPS}); {captures} capture")
    log(f"mesh waves launches (warm-up and capture only): {counts}")
    for kernel in ("rmsnorm_sm90", "flash_attention_sm90"):
        if not counts[kernel] > 0:
            raise AssertionError(f"mesh waves: {kernel} never launched")
    del cases, got
    lower.clear_intern_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": out, "launches": counts}


def mesh_experts(kernels: dict) -> dict:
    """Phase 3m (c): one qwen3-moe layer at full width (d 2048, 128 experts
    top-8, expert d_ff 768, bf16 compute) on 4 x 512 tokens, expert-parallel
    (``moe_impl="shard_map"``) over a (1 data x 2 model) virtual mesh
    against the global dispatch, the sharded run's routing pinned to the
    unsharded run's: within relative L2 2e-2, and ``grouped_matmul_sm90``
    launched 3 times a model shard. Counts are zeroed just before the
    sharded call and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.sharding import partition

    cfg = get_config("qwen3-moe-30b-a3b")
    layer = moe.MoE(cfg, device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    for mod in layer.modules():
        if hasattr(mod, "init_"):
            mod.init_(g)
    x = randn(BATCH, PROMPT, cfg.d_model, dtype=torch.bfloat16,
              gen=torch.Generator("cuda").manual_seed(7))
    sm = dataclasses.replace(cfg, moe_impl="shard_map")
    mesh = _virtual_mesh((1, 2), ("data", "model"))
    routes, own = [], []
    with torch.no_grad(), recorded_routing(routes):
        want, aux_w = moe.moe_apply(layer, cfg, x)
    # ---- main path: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    with torch.no_grad(), partition.use_mesh(mesh), pinned_routing(routes, own):
        got, aux_g = moe.moe_apply(layer, sm, x)
    counts = read_counts(kernels)
    # ---- end of the main path
    diff, total = routing_diff(routes, own)
    err = rel_l2(got, want)
    with torch.no_grad():
        plain_ms, _ = _median_ms(lambda: moe.moe_apply(layer, cfg, x))
        with partition.use_mesh(mesh):
            sharded_ms, _ = _median_ms(lambda: moe.moe_apply(layer, sm, x))
    log(f"mesh experts: {cfg.num_experts} experts over model=2 ({cfg.num_experts // 2} a "
        f"shard), {BATCH}x{PROMPT} tokens: rel L2 {err:.3g} (max abs "
        f"{(got.float() - want.float()).abs().max().item():.3g}), aux {aux_g.item():.6g} vs "
        f"{aux_w.item():.6g}; limit 2e-2; its own router would change {diff} of {total} "
        f"choices; {sharded_ms:.2f} ms sharded, {plain_ms:.2f} ms unsharded (medians of "
        f"{REPS}); launches {counts}")
    if not (err <= TOL[torch.bfloat16] and torch.isfinite(got.float()).all()):
        raise AssertionError("mesh experts: the expert-parallel layer disagrees")
    if counts["grouped_matmul_sm90"] != 3 * 2:
        raise AssertionError(f"mesh experts: grouped_matmul_sm90 launched "
                             f"{counts['grouped_matmul_sm90']} times, want 3 a shard (6)")
    return {"rel_l2": err, "sharded_ms": sharded_ms, "unsharded_ms": plain_ms,
            "routing_changed": diff, "launches": counts}


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
    runs = {}
    for label, continuous in (("moe", False), ("moe continuous", None)):
        run = runs[label] = serve_path(label, "moe", cfg, params, kernels, continuous)
        per_tenant = 3 * cfg.num_layers
        if run["prefill"]["grouped_matmul_sm90"] != TENANTS * per_tenant:
            raise AssertionError(f"grouped matmul (TMA + wgmma) launched "
                                 f"{run['prefill']['grouped_matmul_sm90']} times in prefill, "
                                 f"not {per_tenant} a tenant")
        if not run["decode"]["grouped_matmul_sm90"] > 0:
            raise AssertionError("grouped matmul kernel never launched in decode")
        if run["prefill"]["flash_attention_sm90"] != TENANTS * cfg.num_layers:
            raise AssertionError(f"flash attention (TMA + wgmma) launched "
                                 f"{run['prefill']['flash_attention_sm90']} times in MoE "
                                 f"prefill, not {cfg.num_layers} a tenant")
        need_both(run, "rmsnorm_sm90")

    prompt, first = run["prompts"][0], run["states"][0]["out"][:1]
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
    return runs


def run_mamba(kernels, registry) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("mamba2-370m")
    params = init_model(cfg)
    runs = {}
    for label, continuous in (("mamba2", False), ("mamba2 continuous", None)):
        run = runs[label] = serve_path(label, "mamba2", cfg, params, kernels, continuous)
        if run["prefill"]["ssd_chunk_sm90"] != TENANTS * cfg.num_layers:
            raise AssertionError(f"SSD (tensor cores) launched "
                                 f"{run['prefill']['ssd_chunk_sm90']} times in prefill, not "
                                 f"{cfg.num_layers} a tenant")
        if run["decode"]["ssd_chunk_sm90"] != 0:
            raise AssertionError("SSD kernel launched in decode (the recurrence runs there)")
        need_both(run, "rmsnorm_sm90")
    prompt, first = run["prompts"][0], run["states"][0]["out"][:1]
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
    return runs


# ---------------------------------------------------------------- families

# (arch, layers kept (None: all)): the reference's other seven models at full
# width; chameleon-34b and llama4-scout-17b-a16e at cut depth (f32 params of
# all 48 layers take 137 GB and 431 GB). Layer index 3 is llama4's
# global-attention layer.
FAMILIES = (
    ("glm4-9b", None),
    ("minicpm-2b", None),
    ("minitron-8b", None),
    ("chameleon-34b", 12),
    ("llama4-scout-17b-a16e", 4),
    ("hymba-1.5b", None),
    ("whisper-small", None),
)


def _prefill_attention_calls(cfg) -> int:
    """Flash-attention calls of one prefill (whisper: its encoder layers
    beside each decoder layer's self- and cross-attention)."""
    return cfg.encoder_layers + cfg.num_layers * (2 if cfg.family == "encdec" else 1)


def _layer_input(cfg, seed: int):
    """A bf16 (BATCH, PROMPT, d) input for one block, and whisper's encoder
    output (BATCH, encoder_seq, d), from a seeded card generator."""
    g = torch.Generator("cuda").manual_seed(seed)
    h = randn(BATCH, PROMPT, cfg.d_model, dtype=torch.bfloat16, gen=g)
    enc = (randn(BATCH, cfg.encoder_seq, cfg.d_model, dtype=torch.bfloat16, gen=g)
           if cfg.family == "encdec" else None)
    return h, enc


def run_family(arch: str, layers: int | None, kernels, registry) -> dict:
    """One model of the families phase: serve it (the default continuous
    server, every step a graph replay, one fixed group captured against
    uncaptured), hold its launch counts to what its shapes select, then (a)
    f32 logits, prefill and 3 decode steps, kernels against plain within
    rel L2 1e-3 (llama4's plain run pinned to the kernel run's expert
    choices); (b) layer 0 in bf16 within rel L2 2e-2; (c) the bf16
    whole-model gap, printed with no limit."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = init_model(cfg)
    run = serve_path(arch, arch, cfg, params, kernels, None)
    pre, dec = run["prefill"], run["decode"]
    want_fa = TENANTS * _prefill_attention_calls(cfg)
    if pre["flash_attention_sm90"] != want_fa:
        raise AssertionError(f"{arch}: flash attention (TMA + wgmma) launched "
                             f"{pre['flash_attention_sm90']} times in prefill, not {want_fa}")
    if cfg.family == "encdec":
        if pre["rmsnorm_sm90"] or dec["rmsnorm_sm90"]:
            raise AssertionError(f"{arch}: RMSNorm launched in a LayerNorm model")
    else:
        need_both(run, "rmsnorm_sm90")
    if cfg.num_experts:
        if pre["grouped_matmul_sm90"] != TENANTS * 3 * cfg.num_layers:
            raise AssertionError(f"{arch}: grouped matmul launched {pre['grouped_matmul_sm90']} "
                                 f"times in prefill, not {3 * cfg.num_layers} a tenant")
        if not dec["grouped_matmul_sm90"] > 0:
            raise AssertionError(f"{arch}: grouped matmul never launched in decode")
    if cfg.hybrid_ssm:
        if pre["ssd_chunk_sm90"] != TENANTS * cfg.num_layers or dec["ssd_chunk_sm90"]:
            raise AssertionError(f"{arch}: SSD launched {pre['ssd_chunk_sm90']} times in "
                                 f"prefill (want {TENANTS * cfg.num_layers}) and "
                                 f"{dec['ssd_chunk_sm90']} in decode (want 0)")

    prompt, steps = run["prompts"][0], run["states"][0]["out"][:3]
    moe_ctx = {}
    if cfg.num_experts:   # the plain run takes the kernel run's expert choices
        routes, own = [], []
        moe_ctx = {"kernel_ctx": lambda: recorded_routing(routes),
                   "plain_ctx": lambda: pinned_routing(routes, own)}
    # (a) f32, same weights
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gap32 = logits_gap(params, cfg32, prompt, run["max_len"], registry, steps, **moe_ctx)
    if cfg.num_experts:
        diff, total = routing_diff(routes, own)
        log(f"{arch} f32: the plain run's own router would pick {diff} of {total} top-"
            f"{cfg.top_k} expert choices differently (pinned to the kernel run's)")
    check_gap(f"{arch} f32", gap32, 1e-3)
    # (b) bf16, layer 0 on one input
    h, enc = _layer_input(cfg, 7)
    pos = torch.arange(PROMPT, device="cuda", dtype=torch.int32)[None].expand(BATCH, PROMPT)
    routes, own = [], []
    kctx = (lambda: recorded_routing(routes)) if cfg.num_experts else contextlib.nullcontext
    pctx = (lambda: pinned_routing(routes, own)) if cfg.num_experts else contextlib.nullcontext
    with torch.no_grad():
        with kctx():
            out_k, _, _ = T.block_apply(params.layers[0], cfg, h, pos, layer_idx=0, enc_out=enc)
        with pctx(), registry.kernel_mode_scope("ref"):
            out_r, _, _ = T.block_apply(params.layers[0], cfg, h, pos, layer_idx=0, enc_out=enc)
    layer_err = rel_l2(out_k, out_r)
    log(f"{arch} bf16 layer 0{' (with cross-attention)' if enc is not None else ''}: rel L2 "
        f"{layer_err:.3g} (max abs {(out_k.float() - out_r.float()).abs().max().item():.3g}); "
        f"limit 2e-2")
    if not (layer_err <= 2e-2 and torch.isfinite(out_k.float()).all()):
        raise AssertionError(f"{arch} bf16 layer 0: kernels and plain versions disagree")
    del h, enc, out_k, out_r
    # (c) bf16 whole model: printed, no limit (llama4 unpinned: each run
    # routes by its own router, and the choices that differ are counted)
    routes, own = [], []
    moe_ctx = ({"kernel_ctx": lambda: recorded_routing(routes),
                "plain_ctx": lambda: recorded_routing(own)} if cfg.num_experts else {})
    pre_gap, _, dec_gap, _ = logits_gap(params, cfg, prompt, run["max_len"], registry, steps,
                                        **moe_ctx)
    flips = routing_diff(routes, own) if cfg.num_experts else None
    log(f"{arch} bf16 whole model (no limit): prefill logits rel L2 {pre_gap:.3g}, "
        f"3 decode steps {dec_gap:.3g}"
        + (f"; {flips[0]} of {flips[1]} top-{cfg.top_k} expert choices differ" if flips else ""))

    nparams = sum(p.numel() for p in params.parameters())
    del params, run["states"]
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"family {arch}: {seconds:.1f} s, peak device memory {peak:.2f} GiB; "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved after freeing the model")
    if torch.cuda.memory_reserved() > RESERVED_LIMIT:
        raise AssertionError(f"{arch}: more than 8 GiB reserved after freeing the model")
    return {"layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
            "params": nparams, "seconds": seconds, "peak_gib": peak, **run["metrics"],
            "launches": {"prefill": pre, "decode": dec}, "replayed": run["replayed"],
            "f32_rel_l2": {"prefill": gap32[0], "decode": gap32[2]},
            "bf16_layer0_rel_l2": layer_err,
            "bf16_whole_model_rel_l2": {"prefill": pre_gap, "decode": dec_gap},
            "bf16_expert_choices_differ": flips}


def run_families(kernels, registry) -> dict:
    """The families phase: each of FAMILIES in turn, the previous one freed."""
    t0 = time.perf_counter()
    out = {arch: run_family(arch, layers, kernels, registry) for arch, layers in FAMILIES}
    log(f"phase families: {time.perf_counter() - t0:.1f} s for {len(out)} models")
    return out


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
                 ("attention", torch.float32): ("flash_attention_sm90", "fa_sm90_tf32_kernel")}
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


# ---------------------------------------------------------------- training

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
# the depth of mamba2-370m's fused steps, cut from 48 to keep the script's
# time as the cluster phase grew it
TRAIN_MAMBA_LAYERS = 24
TDG_LAYERS = 8            # of qwen2.5-3b's 36: the region holds ~8 copies of its params
TDG_VOCAB = 152064        # qwen2.5-3b's padded vocabulary: a multiple of 256
TDG_LR = 1e-4             # AdamW's first step moves each weight by about +-lr
# The launcher's lr. At the reference's default 3e-3 (2 warm-up steps of
# 20) mamba2-370m's loss rose (11.222 -> 11.241, first 5 against last 5):
# each early AdamW step moves every weight by about +-lr, a tenth of its
# init scale (1024^-1/2 = 0.031); at 1e-3 it fell (11.216 -> 11.154).
LAUNCHER_LR = "1e-3"
FUSED_REL = 2e-2          # first step's loss and grad norm, kernels vs plain
REGION_LOSS_REL = 1e-5    # region (captured, uncaptured) vs eager
CAPTURED_REL = 1e-6       # captured vs uncaptured
REF_LOSS_RTOL, REF_ATOL, REF_RTOL = 1e-4, 1e-3, 5e-3   # the reference's test tolerances


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference as a share of the largest magnitude of ``want``."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-30)


def _grads_of(fn, inputs, cots):
    xs = [t.detach().requires_grad_() for t in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(outs, xs, cots)


def check_rules(rms, fa, gmm, ssd, ref, gen) -> dict:
    """Each custom op's backward rule at the training path's shapes: the
    kernel's forward plus the rule's backward (the public wrapper under
    autograd) against the plain forward plus autograd, each gradient within
    TOL of its largest magnitude; then the rule alone timed beside its bound.
    Returns the entries' backward fields by kernel entry name."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    def case(label, kernel_fn, plain_fn, inputs, cots, dtype):
        got = _grads_of(kernel_fn, inputs, cots)
        want = _grads_of(plain_fn, inputs, cots)
        err = max(_share(g, w) for g, w in zip(got, want) if w is not None)
        if not all(torch.isfinite(g.float()).all() for g in got) or err > TOL[dtype]:
            raise AssertionError(f"{label}: the rule's gradients differ from plain autograd by "
                                 f"{err:.3g} of the largest magnitude (limit {TOL[dtype]})")
        return err

    def record(name, label, err, dtype, rule, nbytes, flops, flop_dtype, shape):
        ms = time_ms(rule, flush=flush)
        b_ms, b_by = bound(nbytes, flops, flop_dtype)
        log(f"  {label}: rule {ms:.4f} ms ({b_ms / ms:.1%} of the {b_by} bound "
            f"{b_ms:.4f} ms); max err {err:.3g} of the largest magnitude")
        out[name] = {"backward_route": "plain-torch rule", "backward_ms": ms,
                     "backward_bound_ms": b_ms, "backward_bound_by": b_by,
                     "backward_max_err": err, "backward_tolerance": TOL[dtype],
                     "backward_shape": shape}

    log("backward rules (kernel forward + rule vs plain forward + autograd):")
    # RMSNorm: the dense block's shape, with a residual, and mamba2's
    x = randn(TRAIN_BATCH, TRAIN_SEQ, 2048, dtype=bf16, gen=gen)
    w = randn(2048, dtype=f32, gen=gen)
    gy = randn(*x.shape, dtype=bf16, gen=gen)
    err = case("rmsnorm rule (4, 512, 2048) bf16", lambda a, b: rms.rmsnorm(a, b),
               lambda a, b: ref.rmsnorm_ref(a, b), [x, w], [gy], bf16)
    r = randn(*x.shape, dtype=bf16, gen=gen)
    err = max(err, case("rmsnorm rule with residual", lambda a, b, c: rms.rmsnorm(a, b, residual=c),
                        lambda a, b, c: ref.rmsnorm_ref(a, b, residual=c), [x, w, r], [gy], bf16))
    xm, wm = randn(TRAIN_BATCH, TRAIN_SEQ, 1024, dtype=bf16, gen=gen), randn(1024, dtype=f32, gen=gen)
    err = max(err, case("rmsnorm rule (4, 512, 1024) bf16", lambda a, b: rms.rmsnorm(a, b),
                        lambda a, b: ref.rmsnorm_ref(a, b), [xm, wm],
                        [randn(*xm.shape, dtype=bf16, gen=gen)], bf16))
    record("rmsnorm", "rmsnorm (4, 512, 2048) bf16", err, bf16,
           lambda: ref.rmsnorm_bwd_ref(x, w, gy), 2 * 3 * x.numel() + 4 * 2 * w.numel(),
           10 * x.numel(), f32, [TRAIN_BATCH, TRAIN_SEQ, 2048])

    # attention: the dense prefill shape (causal GQA), and an f32 case with
    # a window and a decode offset
    B, S, Hq, Hkv, D = TRAIN_BATCH, TRAIN_SEQ, 16, 2, 128
    q = randn(B, S, Hq, D, dtype=bf16, gen=gen)
    k, v = randn(B, S, Hkv, D, dtype=bf16, gen=gen), randn(B, S, Hkv, D, dtype=bf16, gen=gen)
    go = randn(B, S, Hq, D, dtype=bf16, gen=gen)
    err = case("attention rule (4, 512, 16/2, 128) bf16 causal",
               lambda a, b, c: fa.flash_attention(a, b, c),
               lambda a, b, c: ref.attention_ref(a, b, c), [q, k, v], [go], bf16)
    q2, k2, v2 = (randn(2, 96, 8, 64, dtype=f32, gen=gen), randn(2, 160, 2, 64, dtype=f32, gen=gen),
                  randn(2, 160, 2, 64, dtype=f32, gen=gen))
    kw = dict(window=48, q_offset=64)
    case("attention rule f32 window 48, q_offset 64",
         lambda a, b, c: fa.flash_attention(a, b, c, **kw),
         lambda a, b, c: ref.attention_ref(a, b, c, **kw), [q2, k2, v2],
         [randn(2, 96, 8, 64, dtype=f32, gen=gen)], f32)
    pairs = S * (S + 1) // 2                        # causal: the pairs the data needs
    record("flash_attention", "flash attention (4, 512, 16/2, 128) bf16 causal", err, bf16,
           lambda: ref.attention_bwd_ref(q, k, v, go),
           2 * 2 * (q.numel() + k.numel() + v.numel() + go.numel()),
           5 * 2 * B * Hq * D * pairs, bf16, [B, S, Hq, Hkv, D])

    # grouped matmul: the MoE up projection at prefill capacity
    E, C, d, f = 128, 160, 2048, 768
    xg, wg = randn(E, C, d, dtype=bf16, gen=gen, scale=0.3), randn(E, d, f, dtype=bf16, gen=gen, scale=0.3)
    gg = randn(E, C, f, dtype=bf16, gen=gen, scale=0.3)
    err = case("grouped_matmul rule (128, 160, 2048) @ (128, 2048, 768) bf16",
               lambda a, b: gmm.grouped_matmul(a, b), lambda a, b: ref.grouped_matmul_ref(a, b),
               [xg, wg], [gg], bf16)
    record("grouped_matmul", "grouped matmul (128, 160, 2048) @ (128, 2048, 768) bf16", err, bf16,
           lambda: ref.grouped_matmul_bwd_ref(xg, wg, gg),
           2 * 2 * (xg.numel() + wg.numel() + gg.numel()), 4 * E * C * d * f, bf16, [E, C, d, f])

    # SSD intra-chunk: mamba2's (BH 128, S 512, P 64; BG 4, N 128; chunk 128)
    BH, BG, P, N, Q = TRAIN_BATCH * 32, TRAIN_BATCH, 64, 128, 128
    xs = randn(BH, TRAIN_SEQ, P, dtype=f32, gen=gen, scale=0.1)
    bb, cc = randn(BG, TRAIN_SEQ, N, dtype=f32, gen=gen, scale=0.5), randn(BG, TRAIN_SEQ, N, dtype=f32, gen=gen, scale=0.5)
    lda = -randn(BH, TRAIN_SEQ, dtype=f32, gen=gen).abs() * 0.1
    nc = TRAIN_SEQ // Q
    cots = [randn(BH, TRAIN_SEQ, P, dtype=f32, gen=gen), randn(BH, nc, N, P, dtype=f32, gen=gen),
            randn(BH, nc, 1, 1, dtype=f32, gen=gen)]
    err = case("ssd_intra_chunk rule (mamba2 shape) f32",
               lambda *a: ssd.ssd_intra_chunk(*a, Q), lambda *a: ref.ssd_intra_chunk_ref(*a, Q),
               [xs, bb, cc, lda], cots, f32)
    cells = BH * nc
    record("ssd_intra_chunk", "ssd_intra_chunk (BH 128, S 512, P 64, N 128, Q 128) f32", err, f32,
           lambda: ref.ssd_intra_chunk_bwd_ref(xs, bb, cc, lda, Q, *cots),
           4 * (2 * (xs.numel() + 2 * bb.numel() + lda.numel()) + sum(c.numel() for c in cots)),
           cells * (Q * Q * (4 * P + 6 * N) + 4 * Q * N * P), f32, [BH, TRAIN_SEQ, P, N, Q])
    return out


def _train_data(vocab: int, step: int) -> dict:
    from repro_torch.data import DataConfig, SyntheticLM

    ds = SyntheticLM(DataConfig(vocab_size=vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                seed=0))
    return {"tokens": torch.from_numpy(ds.batch(step)["tokens"]).cuda()}


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def fused_steps(cfg, optimizer, steps: int, mode: str, registry, profile: bool = False) -> dict:
    """``steps`` fused train steps (make_train_step, params and moments in
    place) from the seed-0 weights under kernel mode ``mode``; the step
    times (host clock, synchronized), losses, grad norms and peak memory;
    with ``profile``, one more step under the profiler (its idle share)."""
    from repro_torch.models import model as M
    from repro_torch.training import make_train_step

    _free()
    torch.cuda.reset_peak_memory_stats()
    params = M.params_of(init_model(cfg))
    state = optimizer.init(params)
    step = make_train_step(cfg, optimizer)
    times, losses, gnorms = [], [], []
    with registry.kernel_mode_scope(mode):
        for i in range(steps):
            batch = _train_data(cfg.vocab_size, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
        idle = None
        if profile:
            batch = _train_data(cfg.vocab_size, steps)
            idle = device_profile(f"train step {cfg.name}", lambda: step(params, state, batch))["idle"]
            steps += 1
    if not all(map(torch.isfinite, map(torch.tensor, losses + gnorms))):
        raise AssertionError(f"{cfg.name} {mode}: loss or grad norm not finite")
    if int(state["step"]) != steps:
        raise AssertionError(f"{cfg.name}: opt_state step {int(state['step'])} after {steps}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, state
    _free()
    return {"step_ms": times, "loss": losses, "grad_norm": gnorms, "peak_gib": peak,
            "idle": idle}


def train_fused_model(arch: str, registry, card: str, layers: int = 0) -> dict:
    """One model at full width, at its depth or cut to ``layers``: TRAIN_STEPS
    steps with the kernels, then one on the plain versions from the same
    weights; their first steps' loss and grad norm must agree within
    FUSED_REL."""
    from repro_torch.launch import train as LT

    cfg, optimizer = LT.build(arch, False, TRAIN_SEQ, TRAIN_BATCH, 100, 3e-3, "auto")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    kern = fused_steps(cfg, optimizer, TRAIN_STEPS, "auto", registry, profile=True)
    plain = fused_steps(cfg, optimizer, 1, "ref", registry)
    gaps = {k: abs(kern[k][0] - plain[k][0]) / abs(plain[k][0]) for k in ("loss", "grad_norm")}
    ms = statistics.median(kern["step_ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train {arch} ({cfg.num_layers} layers, remat {cfg.remat}, f32 params, "
        f"{cfg.dtype} compute, batch {TRAIN_BATCH} x {TRAIN_SEQ}): step {ms:.1f} ms (median of "
        f"the last {TRAIN_STEPS - 1}; all {[round(t, 1) for t in kern['step_ms']]}), "
        f"{tokens / ms * 1e3:.0f} tokens/s, peak {kern['peak_gib']:.2f} GiB, idle share of a "
        f"profiled step {kern['idle']}; plain step "
        f"{plain['step_ms'][0]:.1f} ms, peak {plain['peak_gib']:.2f} GiB; losses "
        f"{[round(x, 4) for x in kern['loss']]}; first step kernels vs plain: loss "
        f"{kern['loss'][0]:.6f} / {plain['loss'][0]:.6f}, grad norm {kern['grad_norm'][0]:.6f}"
        f" / {plain['grad_norm'][0]:.6f}, relative gaps {gaps} (limit {FUSED_REL}) ({card})")
    if max(gaps.values()) > FUSED_REL:
        raise AssertionError(f"{arch}: kernel and plain first steps differ: {gaps}")
    return {"arch": arch, "layers": cfg.num_layers, "step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
            "peak_gib": kern["peak_gib"], "idle": kern["idle"], "plain_step_ms": plain["step_ms"][0],
            "losses": kern["loss"], "first_step_gaps": gaps, "all_step_ms": kern["step_ms"]}


def _params_close(label: str, got: dict, want: dict, atol: float, rtol: float) -> float:
    worst = 0.0
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        worst = max(worst, (g - w).abs().max().item())
        if not torch.allclose(g, w, atol=atol, rtol=rtol):
            bad = ((g - w).abs() > atol + rtol * w.abs()).sum().item()
            raise AssertionError(f"{label}: params {k} differ beyond atol {atol}, rtol {rtol} "
                                 f"({bad} of {w.numel()}; max abs {(g - w).abs().max().item():.3g})")
    return worst


def train_region(kernels: dict, registry, card: str) -> dict:
    """The paper's per-layer train region (make_tdg_train_region) on
    qwen2.5-3b at full width, TDG_LAYERS layers: record, EagerExecutor,
    uncaptured replay, captured replay (median of REPS each after the first)."""
    from repro_torch.configs import get_config
    from repro_torch.core import EagerExecutor, lower, lower_tdg, reset_registry
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.training import make_tdg_train_region, make_train_step

    outs = ("params", "opt_state", "loss")

    def keep(out):   # what the comparisons need: params and loss
        return {"params": out["params"], "loss": out["loss"]}

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=TDG_LAYERS)
    opt = adamw(TDG_LR)
    _free()
    torch.cuda.reset_peak_memory_stats()
    p0 = M.params_of(init_model(cfg))
    s0 = opt.init(p0)
    tokens = _train_data(cfg.vocab_size, 0)["tokens"]
    bufs = {"params": p0, "opt_state": s0, "tokens": tokens}
    region = make_tdg_train_region(cfg, opt, name="chip_smoke tdg train")

    def record():
        region.tdg = None               # the next call records again
        return keep(region(**bufs))

    rec_ms, rec = _median_ms(record)
    n = cfg.num_layers
    if region.tdg.num_tasks != 2 * n + 5:
        raise AssertionError(f"train region: {region.tdg.num_tasks} tasks, not {2 * n + 5}")
    eager = EagerExecutor(region.tdg, n_workers=4)
    eager_ms, eag = _median_ms(lambda: keep(eager.run(dict(bufs), outputs=list(outs))))
    unc = lower_tdg(region.tdg, jit=False, donate_slots=("params", "opt_state"), outputs=outs)
    unc_first_ms, _ = _median_ms(lambda: keep(unc(dict(bufs))), reps=1)
    unc_ms, unc_out = _median_ms(lambda: keep(unc(dict(bufs))))

    # captured: donated clones of p0 / s0; the first call warms up, captures, replays
    p_c, s_c = clone(p0), clone(s0)
    before = read_counts(kernels)
    capture_ms, cap = _median_ms(lambda: region(params=p_c, opt_state=s_c, tokens=tokens), reps=1)
    at_capture = read_counts(kernels)
    graph = next(iter(region._replay_cache.values())).graph_replay
    copied = [k for k in p_c if cap["params"][k] is not p_c[k]]
    if copied:
        raise AssertionError(f"captured region returned copies of donated params: {copied[:3]}")
    cap_vs_unc = max(_share(cap["loss"], unc_out["loss"]),
                     max(_share(cap["params"][k], unc_out["params"][k]) for k in p_c))
    if cap_vs_unc > CAPTURED_REL:
        raise AssertionError(f"captured region differs from uncaptured by {cap_vs_unc:.3g}")
    eager_gap = {label: abs(o["loss"].item() - eag["loss"].item()) / abs(eag["loss"].item())
                 for label, o in (("record", rec), ("uncaptured", unc_out), ("captured", cap))}
    if max(eager_gap.values()) > REGION_LOSS_REL:
        raise AssertionError(f"train region loss vs eager: {eager_gap}")
    param_gap = max(_params_close(f"region {label} vs eager", o["params"], eag["params"],
                                  REF_ATOL, REF_RTOL)
                    for label, o in (("record", rec), ("uncaptured", unc_out), ("captured", cap)))
    # pass the donated outputs back: the step advances on the card, one capture
    p_c, s_c = cap["params"], cap["opt_state"]
    for _ in range(2):
        out = region(params=p_c, opt_state=s_c, tokens=tokens)
        if out["params"]["embed.table"] is not p_c["embed.table"] or out["opt_state"]["step"] is not s_c["step"]:
            raise AssertionError("a replay fed its own donated outputs copied them")
        p_c, s_c = out["params"], out["opt_state"]
    steps_done = int(s_c["step"])
    if steps_done != 3 or graph.captures != 1:
        raise AssertionError(f"after 3 captured replays: opt_state step {steps_done}, "
                             f"{graph.captures} captures (want 3 and 1)")
    after3 = read_counts(kernels)
    cap_ms, _ = _median_ms(lambda: region(params=p_c, opt_state=s_c, tokens=tokens))
    in_replays = {k: v - after3[k] for k, v in read_counts(kernels).items() if v != after3[k]}
    if in_replays:
        raise AssertionError(f"a wrapper counted launches during graph replays: {in_replays}")
    names = _graph_kernel_names(lambda: region(params=p_c, opt_state=s_c, tokens=tokens))
    backward = sorted(n_ for n_ in names if "backward" in n_)
    need = [sym for sym in ("rmsnorm_sm90_kernel", "fa_sm90_kernel")
            if not any(sym in n_ for n_ in names)]
    if not backward or need:
        raise AssertionError(f"a trace of one captured replay lacks backward kernels "
                             f"({len(backward)}) or {need}: {sorted(names)[:20]}")
    in_capture = {k: at_capture[k] - before[k] for k in before if at_capture[k] != before[k]}
    del p_c, s_c, cap, out
    region._replay_cache.clear()
    lower.clear_intern_cache()
    _free()

    # region vs the fused step: at this vocabulary the region's CE also
    # spans the pad columns (the reference's head_loss does not mask them)
    fused = make_train_step(cfg, opt)
    p_f, s_f, m_f = fused(clone(p0), clone(s0), {"tokens": tokens})
    pad_gap = eag["loss"].item() - m_f["ce"].item()
    del p_f, s_f, p0, s0, bufs, rec, eag, unc_out
    reset_registry()
    _free()
    peak = torch.cuda.max_memory_allocated() / 2**30

    # ... and at a vocabulary with no pad columns, held to the reference's tolerances
    cfg_v = dataclasses.replace(cfg, vocab_size=TDG_VOCAB)
    p0 = M.params_of(init_model(cfg_v))
    s0 = opt.init(p0)
    tokens_v = _train_data(cfg_v.vocab_size, 0)["tokens"]
    region_v = make_tdg_train_region(cfg_v, opt, name="chip_smoke tdg train vocab")
    rv = keep(region_v(params=p0, opt_state=s0, tokens=tokens_v))
    p_f, s_f, m_f = make_train_step(cfg_v, opt)(clone(p0), clone(s0), {"tokens": tokens_v})
    fv_loss_gap = abs(rv["loss"].item() - m_f["ce"].item()) / abs(m_f["ce"].item())
    if fv_loss_gap > REF_LOSS_RTOL:
        raise AssertionError(f"region vs fused at vocab {TDG_VOCAB}: loss gap {fv_loss_gap:.3g}")
    fv_param = _params_close(f"region vs fused at vocab {TDG_VOCAB}", rv["params"], p_f,
                             REF_ATOL, REF_RTOL)
    del p0, s0, rv, p_f, s_f, region_v
    reset_registry()
    _free()

    log(f"train region qwen2.5-3b at {n} of 36 layers (full width, f32 params, bf16 compute, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW lr {TDG_LR}): {region.tdg.num_tasks} tasks; "
        f"record {rec_ms:.1f} ms (median of {REPS}), eager {eager_ms:.1f} ms, uncaptured {unc_ms:.1f} ms (first "
        f"{unc_first_ms:.1f} ms), captured {cap_ms:.1f} ms (median of {REPS}; first call with "
        f"capture {capture_ms:.1f} ms, {graph.captures} capture for 3 + {REPS + 1} replays, "
        f"opt_state step {steps_done} after 3); captured vs uncaptured {cap_vs_unc:.3g}; loss vs "
        f"eager {eager_gap}; params vs eager max abs {param_gap:.3g}; launches in warm-up + "
        f"capture {in_capture}, 0 in replays; {len(backward)} backward kernels in one replay's "
        f"trace (e.g. {[b[:70] for b in backward[:3]]}); region - fused loss at vocab {cfg.vocab_size} (pad columns "
        f"unmasked in the region) {pad_gap:.6f}; at vocab {TDG_VOCAB}: loss gap {fv_loss_gap:.3g}, "
        f"params max abs {fv_param:.3g}; peak {peak:.2f} GiB ({card})")
    return {"layers": n, "tasks": 2 * n + 5, "record_ms": rec_ms, "eager_ms": eager_ms,
            "uncaptured_ms": unc_ms, "captured_ms": cap_ms, "capture_ms": capture_ms,
            "captures": graph.captures, "captured_vs_uncaptured": cap_vs_unc,
            "loss_vs_eager": eager_gap, "pad_column_loss_gap": pad_gap,
            "vocab_multiple_loss_gap": fv_loss_gap, "vocab_multiple_param_max_abs": fv_param,
            "backward_kernels_in_trace": len(backward), "peak_gib": peak}


def train_launcher() -> dict:
    """The training launcher on mamba2-370m for 20 steps with a checkpoint
    every 10 (its run() is main()'s body and asserts the loss fell); the
    latest checkpoint restored must equal the live state."""
    import shutil
    import tempfile

    from repro_torch.launch import train as LT

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        state, report, losses, ckpt = LT.run(
            ["--arch", "mamba2-370m", "--steps", "20", "--batch", str(TRAIN_BATCH), "--seq",
             str(TRAIN_SEQ), "--ckpt-every", "10", "--ckpt-dir", ckpt_dir, "--lr", LAUNCHER_LR])
        wall = time.perf_counter() - t0
        live = {"params": state.params, "opt_state": state.opt_state}
        restored, step = ckpt.restore({**live, "step": 0})
        if step != 20 or int(restored["step"]) != 20:
            raise AssertionError(f"latest checkpoint is step {step}, not 20")
        differ = [k for k in live["params"] if not torch.equal(restored["params"][k], live["params"][k])]
        differ += [f"{m}/{k}" for m in ("mu", "nu") for k in live["opt_state"][m]
                   if not torch.equal(restored["opt_state"][m][k], live["opt_state"][m][k])]
        if differ or not torch.equal(restored["opt_state"]["step"], live["opt_state"]["step"]):
            raise AssertionError(f"restored checkpoint differs from the live state: {differ[:3]}")
        log(f"train launcher mamba2-370m (lr {LAUNCHER_LR}): 20 steps in {wall:.1f} s, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (first 5 mean {sum(losses[:5]) / 5:.4f}, last 5 mean "
            f"{sum(losses[-5:]) / 5:.4f}); {report}; step-20 checkpoint restored equal")
        del state, live, restored
        return {"losses": losses, "report": report, "wall_s": wall}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        _free()


def run_training(kernels: dict, registry, card: str) -> dict:
    """The training path: fused steps of qwen2.5-3b (36 layers) and
    mamba2-370m (cut to TRAIN_MAMBA_LAYERS of 48: the launcher trains it at
    its full depth), the per-layer train region, and the launcher."""
    t0 = time.perf_counter()
    out = {"dense": train_fused_model("qwen2.5-3b", registry, card),
           "mamba2": train_fused_model("mamba2-370m", registry, card, TRAIN_MAMBA_LAYERS),
           "region": train_region(kernels, registry, card),
           "launcher": train_launcher()}
    _free()
    reserved = torch.cuda.memory_reserved() / 2**30
    log(f"training phase: {time.perf_counter() - t0:.1f} s; {reserved:.2f} GiB reserved after it")
    if torch.cuda.memory_reserved() > RESERVED_LIMIT:
        raise AssertionError("the training phase left more than 8 GiB reserved")
    return out


# ---------------------------------------------------------------- cluster

CLUSTER_SPEC = "repro_torch.launch.serve:build_decode_registry"
# full-width qwen2.5-3b with bf16 params: 6.17 GB, under the wire's 8 GiB
# frame cap, pinned once per worker in its register frame
CLUSTER_KW = {"arch": "qwen2.5-3b", "smoke": False, "device": "cuda",
              "param_dtype": "bfloat16"}
# the spawned worker of the failover run dies at its 3rd submit_batch frame
CLUSTER_KILL_AFTER = 2
CLUSTER_HEARTBEAT = {"heartbeat_secs": 10.0, "lease_misses": 6}


def _cluster_request(st) -> dict:
    return {"tokens": st["tok"][:, None], "pos": st["pos"], "caches": st["caches"]}


def _cluster_tdg(decode, i: int):
    from repro_torch.core import TDG

    tdg = TDG(f"decode[{i}]")
    tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                 outs=["next", "caches"], name="decode")
    return tdg


def _in_process_worker(**server_kwargs):
    """A ``WorkerNode`` serving on a thread of this process, so its kernel
    counts and a profiler trace of its steps are this process's. It links its
    own registry, as a worker process would: its payloads, and so its intern
    cache entries, are its own."""
    from repro_torch.serving import RegionServer, WorkerNode, resolve_registry

    registry = resolve_registry(CLUSTER_SPEC, CLUSTER_KW)
    server = RegionServer(max_batch=TENANTS, max_wait_ms=5.0, device="cuda",
                          name="chip-smoke-worker", **server_kwargs)
    node = WorkerNode(registry, device="cuda", transport="shm", server=server)
    thread = threading.Thread(target=node.serve_forever, name="chip-smoke-worker",
                              daemon=True)
    thread.start()
    return node, thread


def _stop_worker(node, thread) -> None:
    """Wait for an in-process worker its frontend shut down, and drop the
    params and programs it held."""
    thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("an in-process worker did not shut down")
    node._pin_groups.clear()
    node.server.pool.clear()


def _free_run(frontend, states, steps: int) -> dict:
    """``steps`` greedy decode steps of every tenant, one thread a tenant,
    through ``frontend.serve``: the tokens, per-request latencies and wall time."""
    toks = [[st["tok"].cpu()] for st in states]
    lat, errors = [], []

    def loop(i):
        try:
            st = dict(states[i])
            for _ in range(steps):
                t0 = time.perf_counter()
                out = frontend.serve(f"tenant{i}", _cluster_request(st), timeout=600)
                lat.append((time.perf_counter() - t0) * 1e3)
                st = {"tok": out["next"], "pos": st["pos"] + 1, "caches": out["caches"]}
                toks[i].append(out["next"])
        except BaseException as e:   # surface thread failures, don't exit 0
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(i,)) for i in range(len(states))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return {"tokens": [torch.stack(t, 1) for t in toks], "lat_ms": sorted(lat),
            "wall_s": wall}


def _pct(xs: list, q: float) -> float:
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _caches_gap(a: dict, b: dict) -> tuple[bool, float]:
    bitwise, gap = torch.equal(a["next"].cpu(), b["next"].cpu()), 0.0
    if not bitwise:
        raise AssertionError("the fixed group over the wire generated other tokens")
    for x, y in zip(torch.utils._pytree.tree_leaves(a["caches"]),
                    torch.utils._pytree.tree_leaves(b["caches"])):
        x, y = x.cpu(), y.cpu()
        bitwise &= torch.equal(x, y)
        gap = max(gap, (x.float() - y.float()).abs().max().item())
    return bitwise, gap


def _cold_start(label: str, registry, pinned, warm_path: str, state, ship: bool) -> dict:
    """Register -> first served step of one tenant on a fresh in-process
    worker from the warm file: hydrating the shipped program, or (under
    ``REPRO_SHIP_ARTIFACTS=0``) lowering the TDG."""
    import os

    from repro_torch.core import lower
    from repro_torch.serving import ClusterFrontend

    node, thread = _in_process_worker()
    os.environ["REPRO_SHIP_ARTIFACTS"] = "1" if ship else "0"
    try:
        frontend = ClusterFrontend(workers=[f"127.0.0.1:{node.port}"], registry=registry,
                                   device="cuda", transport="shm", heartbeat_secs=0,
                                   name=f"chip-smoke-{label}")
    finally:
        del os.environ["REPRO_SHIP_ARTIFACTS"]
    profiled = None
    try:
        misses = lower.intern_stats()["misses"]
        t0 = time.perf_counter()
        frontend.register_tenant("tenant0", warm_path=warm_path, outputs=("next", "caches"),
                                 pinned=pinned)
        t1 = time.perf_counter()
        frontend.serve("tenant0", _cluster_request(state), timeout=600)
        t2 = time.perf_counter()
        misses = lower.intern_stats()["misses"] - misses
        if ship:    # one warm step of the in-process worker: the hydrated program's graph
            profiled = device_profile("cluster single step (hydrated program, graph replay)",
                                      lambda: frontend.serve("tenant0", _cluster_request(state),
                                                             timeout=600), tries=3)
        stats = frontend.stats()
    finally:
        frontend.close()
        _stop_worker(node, thread)
    agg = stats["aggregate"]
    out = {"register_ms": (t1 - t0) * 1e3, "first_step_ms": (t2 - t1) * 1e3,
           "total_ms": (t2 - t0) * 1e3, "hydrated": agg["hydrated_inband"],
           "intern_misses": misses, "aot_served": agg["aot_served"]}
    log(f"cluster cold start ({label}): register {out['register_ms']:.0f} ms + first "
        f"step {out['first_step_ms']:.0f} ms = {out['total_ms']:.0f} ms; hydrated "
        f"{out['hydrated']}, intern misses {misses}, served by the program {out['aot_served']}")
    if ship:
        names = [n for n in profiled["kernels"] if "rmsnorm_sm90_kernel" in n]
        out["replay_launches"] = {"rmsnorm_sm90_kernel": sum(profiled["kernels"][n][0]
                                                             for n in names)}
        out["card_idle"] = profiled["idle"]
        if not (out["hydrated"] == 1 and misses == 0 and out["aot_served"] == 2 and names):
            raise AssertionError(f"cluster cold start ({label}): the shipped program was not "
                                 f"hydrated, served and replayed with rmsnorm_sm90_kernel "
                                 f"({out})")
    if not ship and not (out["hydrated"] == 0 and misses >= 1):
        raise AssertionError(f"cluster cold start ({label}): with shipping off the worker "
                             f"did not re-lower ({out})")
    return out


def run_cluster(kernels: dict, card: str) -> dict:
    """The cluster tier on the card: full-width qwen2.5-3b (bf16 params) served
    to 4 tenants x batch 4 x prompt 512 (prefilled here) from worker
    processes over RPC. (a) warmup exports the decode step on the card and
    the program ships; the worker it ships to hydrates it (hydrations >= 1,
    no intern miss, no failure, no reject), and a profiled single step on an
    in-process worker replays the program's graph with rmsnorm_sm90; (b) a
    fixed group of 4 over the wire equals the in-process fixed group; (c) a
    free run of 8 steps completes and coalesces; (d) cold start, hydrated
    against re-lowered; (e) a fault plan kills the spawned worker mid-run:
    its tenants re-route, re-ship and finish, the slot is respawned, and each
    tenant then serves tenant0's state alone, held to the in-process step;
    (f) nothing is left running and at most 8 GiB stay reserved beyond the
    params. The profiled single step is (d)'s hydrated worker's second step.
    The launch counts are the prefill's and the cluster serving's; the
    in-process steps (b) and (e) are held to run between the two, uncounted."""
    import multiprocessing
    import os
    import shutil
    import tempfile

    from repro_torch.core import lower
    from repro_torch.launch.serve import build_config, prompt_batch
    from repro_torch.models import model as M
    from repro_torch.serving import RegionServer, resolve_registry

    t_phase = time.perf_counter()
    cfg = build_config("qwen2.5-3b", smoke=False, param_dtype="bfloat16")
    registry = resolve_registry(CLUSTER_SPEC, CLUSTER_KW)
    decode = registry.get("decode")
    with torch.no_grad():
        model = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    pinned = {"params": M.params_of(model)}
    max_len = PROMPT + DECODE_STEPS
    log(f"cluster: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{param_bytes / 1e9:.2f} GB of bf16 params")

    # ---- main path, first part: the frontend's prefill (counts zeroed just
    # before, read just after)
    for mod in kernels.values():
        mod.reset_launches()
    states = []
    with torch.no_grad():
        for i in range(TENANTS):
            logits, caches, pos = M.prefill(model, cfg, prompt_batch(cfg, BATCH, PROMPT, 1 + i,
                                                                     "cuda"), max_len)
            states.append({"tok": torch.argmax(logits[:, -1], -1).to(torch.int32),
                           "pos": pos, "caches": caches})
    in_prefill = read_counts(kernels)
    del logits, caches, pos

    # not the main path: the in-process fixed group (b) is held to, and the
    # single step of tenant0's state the values served after the failover (e)
    # are held to; the same payload, the model
    server = RegionServer(max_batch=TENANTS, max_wait_ms=5.0, autostart=False,
                          device="cuda", name="chip-smoke-cluster-fixed")
    for i in range(TENANTS):
        server.register_tenant(f"tenant{i}", _cluster_tdg(decode, i), outputs=("next", "caches"))
    futs = [server.submit(f"tenant{i}", {"params": model, **_cluster_request(st)})
            for i, st in enumerate(states)]
    server.start()
    fixed_in_process = [f.result(timeout=600) for f in futs]
    single_in_process = server.submit("tenant0", {"params": model,
                                                  **_cluster_request(states[0])}).result(timeout=600)
    server.close()
    del server, futs

    out: dict = {"card": card}
    warm_dir = tempfile.mkdtemp(prefix="chip-smoke-warm-")
    try:
        # ---- main path, second part: the cluster serving (counts zeroed
        # just before, read just after, and added to the prefill's)
        for mod in kernels.values():
            mod.reset_launches()
        _cluster_served(out, cfg, registry, decode, pinned, states, fixed_in_process,
                        single_in_process, os.path.join(warm_dir, "decode.tdg.json"))
        launches = read_counts(kernels)
        out["launches"] = {k: in_prefill[k] + launches[k] for k in launches}
        # ---- end of the main path
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)

    # (f) cleanup
    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"cluster: worker processes left running: {left}")
    del states, fixed_in_process, single_in_process, pinned, model
    lower.clear_intern_cache()
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    log(f"cluster phase: {time.perf_counter() - t_phase:.1f} s; {reserved / 2**30:.2f} GiB "
        f"reserved after it (the params, {param_bytes / 2**30:.2f} GiB, freed)")
    if reserved > RESERVED_LIMIT:
        raise AssertionError("the cluster phase left more than 8 GiB reserved")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _cluster_served(out: dict, cfg, registry, decode, pinned, states, fixed_in_process,
                    single_in_process, warm_path: str) -> None:
    """The cluster's main path, (a)-(e) of :func:`run_cluster`, its results
    written into ``out``."""
    import os

    from repro_torch.core import lower
    from repro_torch.serving import ClusterFrontend, faults

    # ---- F1: the in-process worker A (its server started after the fixed group lands)
    node_a, thread_a = _in_process_worker(autostart=False)
    t0 = time.perf_counter()
    f1 = ClusterFrontend(workers=[f"127.0.0.1:{node_a.port}"], registry=registry,
                         device="cuda", transport="shm", max_batch=TENANTS, max_wait_ms=5.0,
                         heartbeat_secs=0, name="chip-smoke-cluster")
    try:
        attach_ms = (time.perf_counter() - t0) * 1e3
        reg_ms = []
        for i in range(TENANTS):
            t0 = time.perf_counter()
            f1.register_tenant(f"tenant{i}", _cluster_tdg(decode, i), outputs=("next", "caches"),
                               pinned=pinned)
            reg_ms.append((time.perf_counter() - t0) * 1e3)
        shipped = f1.stats()["frontend"]["wire"]["bytes_sent"]
        if f1.stats()["wire"][0]["transport"] != "shm":
            raise AssertionError("cluster: the in-process worker did not take the shm ring")

        # (b) a fixed group of 4 over the wire: all four land before A's server starts
        futs = [f1.submit(f"tenant{i}", _cluster_request(st)) for i, st in enumerate(states)]
        deadline = time.monotonic() + 120
        while node_a.server.metrics.snapshot()["admitted"] < TENANTS:
            if time.monotonic() > deadline:
                raise AssertionError("cluster: the fixed group never reached the worker")
            time.sleep(0.01)
        node_a.server.start()
        fixed_wire = [f.result(timeout=600) for f in futs]
        occupancy = [r["occupancy"] for r in f1.trace()[0]["records"]]
        bitwise, gap = True, 0.0
        for a, b in zip(fixed_wire, fixed_in_process):
            eq, g = _caches_gap(a, b)
            bitwise &= eq
            gap = max(gap, g)
        log(f"cluster (b) fixed group of {TENANTS} over the wire: steps of {occupancy}; "
            f"tokens equal the in-process fixed group's; caches "
            f"{'bitwise equal' if bitwise else f'max abs gap {gap:.3g} (limit bf16 2e-2)'}")
        if occupancy != [TENANTS] or gap > TOL[torch.bfloat16]:
            raise AssertionError(f"cluster fixed group: steps {occupancy}, cache gap {gap:.3g}")

        # (c) the free run: 8 steps of every tenant from 4 threads
        wire0 = f1.stats()["frontend"]["wire"]
        run = _free_run(f1, states, DECODE_STEPS)
        st1 = f1.stats()
        wire1, agg1 = st1["frontend"]["wire"], st1["aggregate"]
        steps = TENANTS * DECODE_STEPS
        free = {"decode_tok_s": steps * BATCH / run["wall_s"], "wall_s": run["wall_s"],
                "p50_ms": _pct(run["lat_ms"], 0.5), "p99_ms": _pct(run["lat_ms"], 0.99),
                "wire_bytes_per_step": (wire1["bytes_sent"] + wire1["bytes_received"]
                                        - wire0["bytes_sent"] - wire0["bytes_received"]) / steps,
                "shm_bytes_per_step": (wire1["shm_bytes_sent"] + wire1["shm_bytes_received"]
                                       - wire0["shm_bytes_sent"]
                                       - wire0["shm_bytes_received"]) / steps,
                "encode_ms_per_step": (wire1["encode_seconds"] - wire0["encode_seconds"])
                * 1e3 / steps,
                "decode_ms_per_step": (wire1["decode_seconds"] - wire0["decode_seconds"])
                * 1e3 / steps,
                "coalesced_requests": agg1["coalesced_requests"],
                "batches": agg1["batches"]}
        log(f"cluster (c) free run: {steps} steps in {run['wall_s'] * 1e3:.1f} ms "
            f"({free['decode_tok_s']:.1f} tok/s over RPC), step p50 {free['p50_ms']:.1f} ms "
            f"p99 {free['p99_ms']:.1f} ms; wire {free['wire_bytes_per_step'] / 1e6:.1f} MB a "
            f"step ({free['shm_bytes_per_step'] / 1e6:.1f} MB through shm), encode "
            f"{free['encode_ms_per_step']:.2f} ms + decode {free['decode_ms_per_step']:.2f} ms "
            f"a step (frontend side); {agg1['batches']} batches, coalesced "
            f"{agg1['coalesced_requests']}")
        if agg1["completed"] != steps + TENANTS or agg1["failed"] or not agg1["coalesced_requests"]:
            raise AssertionError(f"cluster free run: {agg1}")
        for t in run["tokens"]:
            if t.shape != (BATCH, DECODE_STEPS + 1) or not ((t >= 0) & (t < cfg.vocab_size)).all():
                raise AssertionError(f"cluster free run: bad tokens {t.shape}")

        # (a) export the decode step on the card, on worker A, and hold it
        t0 = time.perf_counter()
        report = f1.warmup("tenant0", _cluster_request(states[0]))
        warm_ms = (time.perf_counter() - t0) * 1e3
        record = f1.tenant("tenant0")
        program = node_a.server.pool.peek(node_a.server.tenant("tenant0").aot_key).fn.program
        code = program.graph_module.code
        if "torch.ops.repro_torch.rmsnorm" not in code or record.artifact is None:
            raise AssertionError("cluster: the exported decode step holds no repro_torch::rmsnorm")
        with open(warm_path, "w") as f:
            json.dump(record.tdg_dict, f)
        with open(warm_path + ".aot", "wb") as f:
            f.write(record.artifact)
        log(f"cluster (a) warmup on the card: {warm_ms:.0f} ms (export "
            f"{report['trace_seconds'] * 1e3:.0f} ms, module "
            f"{report['compile_seconds'] * 1e3:.0f} ms); {len(program.graph.nodes)} nodes, "
            f"{code.count('torch.ops.repro_torch.rmsnorm')} repro_torch::rmsnorm calls; "
            f"artifact {len(record.artifact) / 1e6:.2f} MB; cost analysis {report['cost_analysis']}")
        out.update(attach_ms=attach_ms, register_ms=reg_ms, register_bytes=shipped,
                   fixed_group={"occupancy": occupancy, "bitwise": bitwise, "max_abs_gap": gap},
                   free_run=free, warmup_ms=warm_ms, export_ms=report["trace_seconds"] * 1e3,
                   artifact_bytes=len(record.artifact), cost_analysis=report["cost_analysis"])
    finally:
        f1.close()
        _stop_worker(node_a, thread_a)
    del node_a, thread_a, f1

    # ---- F2: a spawned worker (armed to die at its 3rd submit_batch) + in-process A2
    node_b, thread_b = _in_process_worker()
    os.environ[faults.FAULT_PLAN_ENV] = faults.FaultPlan([{
        "role": "worker", "point": "recv", "op": "submit_batch",
        "after": CLUSTER_KILL_AFTER, "action": "kill"}], seed=0).to_json()
    try:
        t0 = time.perf_counter()
        f2 = ClusterFrontend(workers=["local", f"127.0.0.1:{node_b.port}"], registry=CLUSTER_SPEC,
                             registry_kwargs=CLUSTER_KW, device="cuda", transport="shm",
                             max_batch=TENANTS, max_wait_ms=5.0, name="chip-smoke-failover",
                             **CLUSTER_HEARTBEAT)
        spawn_ms = (time.perf_counter() - t0) * 1e3
    finally:
        # the plan was for the spawned worker alone: not this process, not a respawn
        del os.environ[faults.FAULT_PLAN_ENV]
        faults.clear()
    try:
        reg_ms2 = []
        for i in range(TENANTS):
            t0 = time.perf_counter()
            f2.register_tenant(f"tenant{i}", warm_path=warm_path, outputs=("next", "caches"),
                               pinned=pinned)
            reg_ms2.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        f2.serve("tenant0", _cluster_request(states[0]), timeout=600)    # its 1st frame
        first_ms = (time.perf_counter() - t0) * 1e3
        spawned = f2.stats()["workers"][0]
        hyd = {"hydrations": spawned["pool"]["hydrations"],
               "intern_misses": spawned["intern"]["misses"],
               "aot_hydrate_failures": spawned["metrics"]["aot_hydrate_failures"],
               "aot_topology_rejects": spawned["metrics"]["aot_topology_rejects"],
               "aot_served": spawned["metrics"]["aot_served"]}
        log(f"cluster (a) the spawned worker (pid {spawned['worker']['pid']}, "
            f"{spawned['worker']['transport']}): spawned in {spawn_ms:.0f} ms, 4 tenants "
            f"registered from the warm file in {[round(x) for x in reg_ms2]} ms, first step "
            f"{first_ms:.0f} ms; {hyd}")
        if not (hyd["hydrations"] >= 1 and hyd["intern_misses"] == 0 and hyd["aot_served"] >= 1
                and hyd["aot_hydrate_failures"] == 0 and hyd["aot_topology_rejects"] == 0):
            raise AssertionError(f"cluster: the spawned worker did not serve the hydrated "
                                 f"program alone ({hyd})")

        # (e) the failover run: the spawned worker dies at its 3rd submit_batch
        misses = lower.intern_stats()["misses"]
        run2 = _free_run(f2, states, DECODE_STEPS)
        misses = lower.intern_stats()["misses"] - misses
        deadline = time.monotonic() + 180
        while f2.respawns < 1 and time.monotonic() < deadline:
            time.sleep(0.2)
        st2 = f2.stats()
        fr2 = st2["frontend"]
        a2 = st2["workers"][1]
        fail = {"worker_deaths": fr2["worker_deaths"], "requeues": fr2["requeues"],
                "retries": fr2["retries"], "respawns": fr2["respawns"],
                "pin_groups_shipped": fr2["pin_groups_shipped"],
                "artifacts_shipped": fr2["artifacts_shipped"],
                "artifact_bytes_shipped": fr2["artifact_bytes_shipped"],
                "sibling_hydrations": a2["pool"]["hydrations"],
                "sibling_intern_misses": misses,
                "failover_ms": run2["lat_ms"][-1], "wall_s": run2["wall_s"]}
        log(f"cluster (e) failover: {fail}; tenants on {[r['worker'] for r in st2['tenants'].values()]}")
        if not (fail["worker_deaths"] == 1 and fail["requeues"] >= 1 and fail["respawns"] >= 1
                and fail["pin_groups_shipped"] >= 2 and fail["artifacts_shipped"] >= 2 * TENANTS
                and fail["sibling_hydrations"] >= 1 and misses == 0):
            raise AssertionError(f"cluster failover: {fail}")
        for t in run2["tokens"]:
            if t.shape != (BATCH, DECODE_STEPS + 1) or not ((t >= 0) & (t < cfg.vocab_size)).all():
                raise AssertionError(f"cluster failover: not every step was served {t.shape}")
        # the failover run's batches form as requests come, so its values are
        # held to nothing; each tenant, re-shipped to where it is routed now,
        # then serves tenant0's state alone, held to the in-process step
        after = {}
        for i in range(TENANTS):
            got = f2.serve(f"tenant{i}", _cluster_request(states[0]), timeout=600)
            eq, g = _caches_gap(got, single_in_process)
            after[f"tenant{i}"] = {"worker": f2.tenant(f"tenant{i}").worker, "bitwise": eq,
                                   "max_abs_gap": g}
        log(f"cluster (e) after the failover each tenant serves tenant0's state alone: tokens "
            f"equal the in-process step's; {after}")
        if any(a["max_abs_gap"] > TOL[torch.bfloat16] for a in after.values()):
            raise AssertionError(f"cluster failover: served values differ from the "
                                 f"in-process step's ({after})")
        fail["after"] = after

        out.update(spawn_ms=spawn_ms, register_ms_spawned=reg_ms2,
                   first_step_ms_spawned=first_ms, spawned_worker=hyd, failover=fail)
    finally:
        f2.close()
        _stop_worker(node_b, thread_b)
    del node_b, thread_b, f2

    # (d) cold start: register -> first served step, hydrated against re-lowered
    out["cold_start"] = {"hydrated": _cold_start("hydrated", registry, pinned, warm_path,
                                                 states[0], ship=True),
                         "relowered": _cold_start("relowered", registry, pinned, warm_path,
                                                  states[0], ship=False)}


# ---------------------------------------------------------------- distributed

PIPE_STAGES, PIPE_MICRO = 4, 8      # qwen2.5-3b's 36 blocks as 4 stages of 9
DIST_REL = 2e-2                     # bf16 compute: the training phase's FUSED_REL
MESH_TRAIN_STEPS = 3
# The elastic run checkpoints the mesh drive's setup at this depth: the
# Checkpointer writes npz with a CRC-32 a leaf (~0.75 GB/s on one host
# core), and all 36 layers' params and moments take 37 GB.
ELASTIC_LAYERS = 2
DRYRUN_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import ReplayMesh
out = {}
t0 = time.perf_counter()
mesh = ReplayMesh((2, 2), ("data", "model"), ["meta"] * 4)
out["mesh_train"] = D.lower_cell("qwen2.5-3b", ShapeConfig("mesh_train", 512, 4, "train"),
                                 mesh=mesh, opts={"loss_chunk": "0"}, save=False)
out["mesh_train"]["wall_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
out["train_4k"] = D.lower_cell("qwen2.5-3b", "train_4k", save=False)
out["train_4k"]["wall_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def start_dryrun() -> subprocess.Popen:
    """Start drive (d)'s dry-runs in a child process: they run on ``meta``
    tensors (no card; one host core, a few minutes of fake-tensor ops for
    the 16 x 16 cell) beside the card's drives; ``run_distributed``
    collects them."""
    return subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, str(SRC)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _bits(tree: dict) -> torch.Tensor:
    """Each f32 leaf's bit patterns summed in int64 (bitwise-equal trees
    give equal sums)."""
    return torch.stack([t.detach().contiguous().view(torch.int32).sum(dtype=torch.int64)
                        for t in tree.values()])


def _grad_norm(grads) -> float:
    from repro_torch.optim.adamw import global_norm

    return global_norm(list(grads)).item()


def _stage_fn(cfg, per: int):
    """``stage_fn(params, x)``: ``per`` decoder blocks (the stage's
    ``layers.j.*`` leaves) over x (mb, S, d), remat as the config says."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    def stage_fn(p, x):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None].expand(x.shape[0], -1)
        y, _, _ = T.decoder_stack([M.bind(cfg, p, layer=j) for j in range(per)], cfg, x,
                                  positions)
        return y
    return stage_fn


def _apply_stages(stage_fn, stacked: dict, x, n_stages: int):
    for s in range(n_stages):
        x = stage_fn({k: v[s] for k, v in stacked.items()}, x)
    return x


def _head_loss(cfg, table, final_norm: dict, h, tokens) -> torch.Tensor:
    """The model's cross-entropy of final hidden states ``h`` (B, S, d):
    the final norm, the tied unembedding, CE over the shifted labels."""
    import types

    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    hn = T.norm(cfg, types.SimpleNamespace(**final_norm), h)
    head = types.SimpleNamespace(embed=types.SimpleNamespace(table=table), head=None)
    tot, cnt = M._ce_chunk(head, cfg, hn, *M.loss_labels({"tokens": tokens}))
    return tot / cnt


def run_pipeline(kernels: dict, registry, card: str) -> dict:
    """(a) qwen2.5-3b at full width, its 36 blocks stacked into 4 stages of
    9 on 4 virtual positions of this card, 8 microbatches of 1 x 512
    tokens, f32 params, bf16 compute; the embedding and the head (final
    norm, tied unembedding, CE) outside the pipeline. Counts are zeroed
    just before the pipeline's runs (a forward, then a forward and
    backward) and read just after; the comparisons come after them."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.core import pipeline_tdg, topo_waves
    from repro_torch.core.pipeline import bubble_fraction, pipeline_apply, pipeline_waves
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = get_config("qwen2.5-3b")
    S, Mb, per = PIPE_STAGES, PIPE_MICRO, cfg.num_layers // PIPE_STAGES
    _free()
    torch.cuda.reset_peak_memory_stats()
    params = M.params_of(init_model(cfg))
    stacked = {}
    for j in range(per):
        for name in [n for n in params if n.startswith(f"layers.{j}.")]:
            leaf = name[len(f"layers.{j}."):]
            stacked[name] = torch.stack([params[f"layers.{s * per + j}.{leaf}"]
                                         for s in range(S)]).requires_grad_()
    params = {k: v for k, v in params.items() if not k.startswith("layers.")}
    _free()
    table = params["embed.table"]
    final_norm = {k.split(".")[-1]: v for k, v in params.items() if k.startswith("final_norm.")}
    tokens = torch.cat([_train_data(cfg.vocab_size, i)["tokens"] for i in range(2)])  # (8, 512)
    with torch.no_grad():
        xs = (L.embed(types.SimpleNamespace(table=table), tokens, cfg.compute_dtype)
              * cfg.embed_scale)[:, None]                                 # (8, 1, 512, d)
    mesh = _virtual_mesh((S,), ("stage",))
    stage_fn = _stage_fn(cfg, per)
    leaves = list(stacked.values())

    def pipeline_loss():
        out = pipeline_apply(stage_fn, stacked, xs, mesh)
        return _head_loss(cfg, table, final_norm, out[:, 0], tokens)

    def sequential_loss():      # the stack without the pipeline: a stage over the whole batch
        return _head_loss(cfg, table, final_norm, _apply_stages(stage_fn, stacked, xs[:, 0], S),
                          tokens)

    def grads_of(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fn()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), grads, (time.perf_counter() - t0) * 1e3

    # ---- the pipeline's runs: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = pipeline_apply(stage_fn, stacked, xs, mesh)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    loss, grads, pipe_ms = grads_of(pipeline_loss)
    launches = read_counts(kernels)
    # ---- end of the pipeline's runs
    gnorm = _grad_norm(grads)
    del grads
    blocks = cfg.num_layers * Mb
    remat = 2 if cfg.remat != "none" else 1      # a remat block runs again in the backward
    predicted = {"rmsnorm_sm90": 2 * blocks + 2 * blocks * remat + 1,   # + the final norm
                 "flash_attention_sm90": blocks + blocks * remat}

    with torch.no_grad():
        by_micro = torch.stack([_apply_stages(stage_fn, stacked, xs[m], S) for m in range(Mb)])
        whole = _apply_stages(stage_fn, stacked, xs[:, 0], S)[:, None]
    if not torch.equal(out, by_micro):
        raise AssertionError("the pipeline's forward differs from the stack applied "
                             "microbatch by microbatch")
    gaps = {"forward vs whole batch (rel L2)": rel_l2(out, whole)}
    del by_micro, whole
    seq_loss, seq_grads, seq_ms = grads_of(sequential_loss)
    seq_gnorm = _grad_norm(seq_grads)
    del seq_grads
    with registry.kernel_mode_scope("ref"):
        ref_loss, ref_grads, ref_ms = grads_of(pipeline_loss)
    ref_gnorm = _grad_norm(ref_grads)
    del ref_grads
    gaps.update({
        "loss vs sequential": abs(loss.item() - seq_loss.item()) / abs(seq_loss.item()),
        "grad norm vs sequential": abs(gnorm - seq_gnorm) / seq_gnorm,
        "loss vs plain pipeline": abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()),
        "grad norm vs plain pipeline": abs(gnorm - ref_gnorm) / ref_gnorm})
    waves = len(topo_waves(pipeline_tdg(S, Mb, include_backward=False)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"pipeline qwen2.5-3b ({cfg.num_layers} blocks as {S} stages of {per} on {S} virtual "
        f"positions of this card, {Mb} microbatches of 1 x {TRAIN_SEQ}, remat {cfg.remat}, "
        f"f32 params, bf16 compute): {waves} waves (pipeline_waves {pipeline_waves(S, Mb)}), "
        f"bubble fraction {bubble_fraction(S, Mb):.4f}; forward {fwd_ms:.1f} ms; forward + "
        f"backward: pipeline {pipe_ms:.1f} ms, sequential (a stage over the whole batch) "
        f"{seq_ms:.1f} ms, the pipeline on the plain versions {ref_ms:.1f} ms; loss "
        f"{loss.item():.6f} (sequential {seq_loss.item():.6f}, plain {ref_loss.item():.6f}), "
        f"grad norm {gnorm:.6f} (sequential {seq_gnorm:.6f}, plain {ref_gnorm:.6f}); forward "
        f"bitwise equal to the stack microbatch by microbatch; gaps {gaps} (limit {DIST_REL}); "
        f"launches {launches}, predicted {predicted}; peak {peak:.2f} GiB ({card})")
    if waves != pipeline_waves(S, Mb) or waves != Mb + S - 1:
        raise AssertionError(f"pipeline waves {waves}, pipeline_waves {pipeline_waves(S, Mb)}")
    if max(gaps.values()) > DIST_REL:
        raise AssertionError(f"pipeline gaps beyond {DIST_REL}: {gaps}")
    if {k: launches[k] for k in predicted} != predicted:
        raise AssertionError(f"pipeline launches {launches}, predicted {predicted}")
    if any(launches[k] for k in FIRST_DESIGNS):
        raise AssertionError(f"a first design launched on the pipeline path: {launches}")
    del stacked, leaves, params, xs, out, table, final_norm
    _free()
    return {"stages": S, "microbatches": Mb, "waves": waves,
            "bubble_fraction": bubble_fraction(S, Mb), "forward_ms": fwd_ms,
            "pipeline_ms": pipe_ms, "sequential_ms": seq_ms, "plain_pipeline_ms": ref_ms,
            "loss": loss.item(), "grad_norm": gnorm, "gaps": gaps, "launches": launches,
            "predicted_launches": predicted, "peak_gib": peak}


def _mesh_train_cfg(layers: int = 0):
    """The training drive's qwen2.5-3b (the launcher's config: no loss
    chunking; AdamW with warmup-cosine from 3e-3), cut to ``layers``."""
    from repro_torch.launch import train as LT

    cfg, optimizer = LT.build("qwen2.5-3b", False, TRAIN_SEQ, TRAIN_BATCH, 100, 3e-3, "auto")
    return (dataclasses.replace(cfg, num_layers=layers) if layers else cfg), optimizer


def _fresh_state(cfg, optimizer):
    """The seed-0 weights and a fresh optimizer state, peak memory reset."""
    from repro_torch.models import model as M

    _free()
    torch.cuda.reset_peak_memory_stats()
    params = M.params_of(init_model(cfg))
    return params, optimizer.init(params)


def _steps(step, params, state, vocab: int, batches) -> dict:
    """Train steps on SyntheticLM's batches ``batches`` (host clock around
    synchronized steps)."""
    times, losses, gnorms = [], [], []
    for i in batches:
        batch = _train_data(vocab, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    return {"step_ms": times, "loss": losses, "grad_norm": gnorms}


def _chunk_by_chunk_step(cfg, optimizer, params, state, batch, n_shards: int) -> dict:
    """The mesh step written out by hand: each contiguous chunk through the
    unsharded loss and gradients, weighted by its token share, summed in
    shard order; then AdamW once."""
    from repro_torch.models import model as M

    B = batch["tokens"].shape[0]
    rows = [{k: v[i * B // n_shards:(i + 1) * B // n_shards] for k, v in batch.items()}
            for i in range(n_shards)]
    counts = [M.loss_labels(r)[1].sum() for r in rows]
    total = torch.clamp(torch.stack(counts).sum(), min=1.0)
    grads, loss = {}, None
    for r, c in zip(rows, counts):
        w = c / total
        with torch.enable_grad():
            diff = {k: v.detach().requires_grad_() for k, v in params.items()}
            l, m = M.loss_fn(M.bind(cfg, diff), cfg, r)
            g = torch.autograd.grad(l * w, list(diff.values()))
        for k, v in zip(diff, g):
            grads[k] = v if k not in grads else grads[k] + v
        part = m["loss"].detach() * w
        loss = part if loss is None else loss + part
    om = optimizer.update_(grads, state, params)
    return {"loss": loss.item(), "grad_norm": om["grad_norm"].item()}


def run_mesh_train(kernels: dict, registry, card: str) -> dict:
    """(b) qwen2.5-3b at full width and depth (f32 params, bf16 compute,
    remat), batch 4 x 512 of SyntheticLM, trained under a virtual 2 x 2
    (data, model) mesh of this card: each step's two batch chunks run
    forward and backward in turn, their gradients summed in shard order,
    then clipping and AdamW once. Each run starts from the seed-0 weights:
    the unsharded step (3 steps), the step written out chunk by chunk (1),
    the mesh step (3; launch counts zeroed just before and read just after;
    FlopCounterMode around its first step) and the mesh step on the plain
    versions (1, FlopCounterMode: drive (d) holds the dry-run to it)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun as D
    from repro_torch.training import make_train_step

    cfg, optimizer = _mesh_train_cfg()
    mesh = _virtual_mesh((2, 2), ("data", "model"))
    vocab, steps = cfg.vocab_size, range(MESH_TRAIN_STEPS)
    params, state = _fresh_state(cfg, optimizer)
    un = _steps(make_train_step(cfg, optimizer), params, state, vocab, steps)
    un["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, state

    params, state = _fresh_state(cfg, optimizer)
    cc = _chunk_by_chunk_step(cfg, optimizer, params, state, _train_data(vocab, 0), 2)
    cc_bits = _bits(params), _bits(state["mu"]), _bits(state["nu"])
    del params, state

    params, state = _fresh_state(cfg, optimizer)
    placed = D.argument_bytes({"params": params, "opt_state": state},
                              {"batch": _train_data(vocab, 0)}, mesh)
    step = make_train_step(cfg, optimizer, mesh=mesh)
    # ---- the mesh train path: counts zeroed just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    sh = _steps(step, params, state, vocab, steps[:1])
    bits = _bits(params), _bits(state["mu"]), _bits(state["nu"])
    rest = _steps(step, params, state, vocab, steps[1:])
    launches = read_counts(kernels)
    # ---- end of the mesh train path
    for k in sh:
        sh[k] += rest[k]
    sh["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, state, step

    # FlopCounterMode decomposes the ops it has no formula for, so a step
    # under it takes other bits: this run is counted, never compared bitwise
    params, state = _fresh_state(cfg, optimizer)
    with registry.kernel_mode_scope("ref"), FlopCounterMode(display=False) as plain_counter:
        plain = _steps(make_train_step(cfg, optimizer, mesh=mesh), params, state, vocab,
                       steps[:1])
    plain_flops = plain_counter.get_total_flops()
    del params, state
    _free()

    gaps = {k: abs(sh[k][0] - un[k][0]) / abs(un[k][0]) for k in ("loss", "grad_norm")}
    gaps["plain loss"] = abs(sh["loss"][0] - plain["loss"][0]) / abs(plain["loss"][0])
    blocks = 2 * cfg.num_layers                   # two chunks a step
    remat = 2 if cfg.remat != "none" else 1
    predicted = {"rmsnorm_sm90": MESH_TRAIN_STEPS * (2 * blocks * remat + 2),
                 "flash_attention_sm90": MESH_TRAIN_STEPS * blocks * remat}
    ms, un_ms = statistics.median(sh["step_ms"][1:]), statistics.median(un["step_ms"][1:])
    bitwise = (sh["loss"][0] == cc["loss"] and sh["grad_norm"][0] == cc["grad_norm"]
               and all(torch.equal(a, b) for a, b in zip(bits, cc_bits)))
    log(f"mesh train qwen2.5-3b ({cfg.num_layers} layers, f32 params, bf16 compute, remat "
        f"{cfg.remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ}) on a virtual 2 x 2 mesh: step "
        f"{ms:.1f} ms (median of steps 2-{MESH_TRAIN_STEPS}; all "
        f"{[round(t, 1) for t in sh['step_ms']]}), peak {sh['peak_gib']:.2f} GiB; unsharded "
        f"step {un_ms:.1f} ms (all {[round(t, 1) for t in un['step_ms']]}), peak "
        f"{un['peak_gib']:.2f} GiB; losses {[round(x, 6) for x in sh['loss']]} (unsharded "
        f"{[round(x, 6) for x in un['loss']]}); step 1 loss {sh['loss'][0]:.6f} / "
        f"{un['loss'][0]:.6f}, grad norm {sh['grad_norm'][0]:.6f} / {un['grad_norm'][0]:.6f}, "
        f"gaps {gaps} (limit {DIST_REL}); bitwise equal to the chunk-by-chunk step (loss, "
        f"grad norm, params, moments): {bitwise}; FLOPs of step 1 on the plain versions "
        f"(FlopCounterMode): {plain_flops:.6g}; launches {launches}, predicted {predicted} "
        f"({card})")
    if max(gaps.values()) > DIST_REL:
        raise AssertionError(f"mesh train step 1 differs beyond {DIST_REL}: {gaps}")
    if not bitwise:
        raise AssertionError("the mesh step differs from the step run chunk by chunk")
    if {k: launches[k] for k in predicted} != predicted:
        raise AssertionError(f"mesh train launches {launches}, predicted {predicted}")
    if any(launches[k] for k in FIRST_DESIGNS):
        raise AssertionError(f"a first design launched on the mesh train path: {launches}")
    return {"layers": cfg.num_layers, "step_ms": ms, "all_step_ms": sh["step_ms"],
            "peak_gib": sh["peak_gib"], "unsharded_step_ms": un_ms,
            "unsharded_peak_gib": un["peak_gib"], "losses": sh["loss"],
            "unsharded_losses": un["loss"], "gaps": gaps, "bitwise_chunk_by_chunk": bitwise,
            "plain_flops": plain_flops,
            "placed_bytes": placed, "launches": launches, "predicted_launches": predicted}


def run_elastic(card: str) -> dict:
    """(c) The mesh drive's setup at ELASTIC_LAYERS layers: 3 steps on the
    virtual 2 x 2 mesh with an async checkpoint (the port's Checkpointer)
    after step 2; then the checkpoint restored as host arrays,
    ``reshard_checkpoint`` onto a virtual (1, 2) mesh, gathered whole on
    this card and step 3 taken again there: its loss within DIST_REL of the
    uninterrupted step 3's."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime import elastic_restart_plan, gather_checkpoint, reshard_checkpoint
    from repro_torch.training import make_train_step

    cfg, optimizer = _mesh_train_cfg(ELASTIC_LAYERS)
    big, small = _virtual_mesh((2, 2), ("data", "model")), _virtual_mesh((1, 2), ("data", "model"))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        params, state = _fresh_state(cfg, optimizer)
        step = make_train_step(cfg, optimizer, mesh=big)
        run = _steps(step, params, state, cfg.vocab_size, range(2))
        ckpt = Checkpointer(ckpt_dir)
        t0 = time.perf_counter()
        ckpt.save({"params": params, "opt_state": state}, step=2)
        snapshot_s = time.perf_counter() - t0
        third = _steps(step, params, state, cfg.vocab_size, range(2, 3))
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*params.values(), *state["mu"].values(), *state["nu"].values()))
        del params, state, step
        _free()
        t0 = time.perf_counter()
        tree, at = ckpt.restore(None)
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = gather_checkpoint(reshard_checkpoint(tree, small), small, "cuda")
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        resumed = _steps(make_train_step(cfg, optimizer, mesh=small), tree["params"],
                         tree["opt_state"], cfg.vocab_size, range(2, 3))
        step_after = int(tree["opt_state"]["step"])
        del tree
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        _free()
    plan = elastic_restart_plan(4, 2, TRAIN_BATCH)
    gap = abs(resumed["loss"][0] - third["loss"][0]) / abs(third["loss"][0])
    log(f"elastic qwen2.5-3b ({cfg.num_layers} of 36 layers, full width): steps 1-3 on a "
        f"virtual 2 x 2 mesh, losses {run['loss'] + third['loss']}; checkpoint of step {at} "
        f"({nbytes / 2**30:.2f} GiB of params and moments): snapshot {snapshot_s:.1f} s, "
        f"restored as host arrays in {restore_s:.1f} s (after the async write), resharded onto "
        f"a virtual (1, 2) mesh and gathered whole in {reshard_s:.1f} s; step 3 there loss "
        f"{resumed['loss'][0]:.6f} against {third['loss'][0]:.6f} uninterrupted (gap {gap:.3g}, "
        f"limit {DIST_REL}); optimizer step after it {step_after}; elastic_restart_plan(4, 2, "
        f"{TRAIN_BATCH}) = {plan} ({card})")
    if at != 2 or step_after != 3:
        raise AssertionError(f"resumed from step {at}, optimizer step {step_after} after it")
    if gap > DIST_REL:
        raise AssertionError(f"the resumed step 3 differs from the uninterrupted one: {gap}")
    return {"layers": cfg.num_layers, "losses": run["loss"] + third["loss"],
            "resumed_loss": resumed["loss"][0], "gap": gap, "checkpoint_gib": nbytes / 2**30,
            "snapshot_s": snapshot_s, "restore_s": restore_s, "reshard_s": reshard_s,
            "plan": plan}


def collect_dryrun(proc: subprocess.Popen, mesh_train: dict, card: str) -> dict:
    """(d) The dry-runs started by ``start_dryrun``: the mesh drive's own
    cell (a train ShapeConfig of 4 x 512 on a 2 x 2 meta mesh) must count
    the FLOPs FlopCounterMode counted in one real step of it (on the plain
    versions, the ops the dry-run's meta tensors take), and place the bytes
    the drive placed at each position; its roofline seconds beside the
    drive's step time. Then qwen2.5-3b train_4k on the 16 x 16 production
    mesh of meta positions: its record and wall time."""
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import ReplayMesh

    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("the dry-run child did not finish within 900 s") from None
    waited = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"the dry-run child failed ({proc.returncode}):\n{err[-4000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    cell, prod = rec["mesh_train"], rec["train_4k"]
    cfg, optimizer = _mesh_train_cfg()
    meta = ReplayMesh((2, 2), ("data", "model"), ["meta"] * 4)
    sp = SP.input_specs(cfg, ShapeConfig("mesh_train", TRAIN_SEQ, TRAIN_BATCH, "train"), meta,
                        optimizer)
    spec_placed = D.argument_bytes({"params": sp["params"], "opt_state": sp["opt_state"]},
                                   {"batch": sp["batch"]}, meta)
    placed = mesh_train["placed_bytes"]
    rl = cell["roofline"]
    log(f"dry-run of the mesh drive's cell (qwen2.5-3b train {TRAIN_BATCH} x {TRAIN_SEQ}, 2 x 2 "
        f"meta mesh): "
        f"FLOPs {cell['collectives']['flops_global']:.6g} (one real step on the plain "
        f"versions: {mesh_train['plain_flops']:.6g}), busiest position "
        f"{cell['memory']['position']}: {rl['hlo_flops_per_device']:.6g} FLOPs, "
        f"{rl['hlo_bytes_per_device']:.6g} bytes, arguments "
        f"{cell['memory']['argument_size_in_bytes']} bytes (the drive placed {placed}; the "
        f"reference's layout {cell['memory']['reference_layout_argument_size_in_bytes']}); "
        f"roofline compute {rl['compute_s'] * 1e3:.2f} ms, memory {rl['memory_s'] * 1e3:.2f} ms, "
        f"collective {rl['collective_s'] * 1e3:.2f} ms ({rl['dominant']}) against the measured "
        f"step {mesh_train['step_ms']:.1f} ms; fake run {cell['wall_s']:.1f} s ({card})")
    rl4 = prod["roofline"]
    log(f"dry-run qwen2.5-3b train_4k on the {prod['mesh']} production mesh (meta): wall "
        f"{prod['wall_s']:.1f} s (the phase waited {waited:.1f} s for the child); "
        f"{json.dumps(prod)}")
    if cell["collectives"]["flops_global"] != mesh_train["plain_flops"]:
        raise AssertionError("the dry-run's FLOPs differ from the real step's")
    if spec_placed != {int(k): v for k, v in placed.items()} or \
            cell["memory"]["argument_size_in_bytes"] != placed[0]:
        raise AssertionError(f"dry-run placement {spec_placed} differs from the drive's {placed}")
    shape = SHAPES["train_4k"]
    want = cfg.model_flops_per_token(shape.seq_len) * shape.tokens_per_step
    if prod["roofline"]["model_flops_global"] != want or prod["cost_mode"] != "exact":
        raise AssertionError("the production cell's model FLOPs are not the config's")
    return {"mesh_train": {"flops": cell["collectives"]["flops_global"],
                           "roofline": rl, "memory": cell["memory"],
                           "collectives": cell["collectives"], "wall_s": cell["wall_s"],
                           "measured_step_ms": mesh_train["step_ms"]},
            "train_4k": prod, "waited_s": waited}


def run_distributed(kernels: dict, registry, card: str, dryrun: subprocess.Popen) -> dict:
    """Phase 7: pipeline (a), training under a mesh (b), elastic (c), the
    dry-run against the card (d); each drive's launch counts zeroed just
    before its main path and read just after."""
    t0 = time.perf_counter()
    out = {"pipeline": run_pipeline(kernels, registry, card),
           "mesh_train": run_mesh_train(kernels, registry, card),
           "elastic": run_elastic(card)}
    out["dryrun"] = collect_dryrun(dryrun, out["mesh_train"], card)
    _free()
    out["seconds"] = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved() / 2**30
    log(f"distributed phase: {out['seconds']:.1f} s; {reserved:.2f} GiB reserved after it")
    if torch.cuda.memory_reserved() > RESERVED_LIMIT:
        raise AssertionError("the distributed phase left more than 8 GiB reserved")
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
    rules = check_rules(rms, fa, gmm, ssd, ref, gen)
    for e in entries:
        e.update(rules.get(e["name"], {}))
    entries += check_new_shapes(rms, fa, gmm, ssd, ref, gen)
    log(f"phase 2 (kernels and their backward rules) took {time.perf_counter() - t0:.1f} s")

    kernels = {"rmsnorm": rms, "flash_attention": fa, "grouped_matmul": gmm, "ssd": ssd}
    runs, replayed, mesh = {}, {}, {}
    for family, run_fn in (("dense", run_dense), ("moe", run_moe), ("mamba2", run_mamba)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for label, run in run_fn(kernels, registry).items():
            runs[label] = {k: run["prefill"][k] + run["decode"][k] for k in run["prefill"]}
            replayed[label] = run["replayed"]
            if "mesh" in run:
                mesh["serve"] = run["mesh"]
        gc.collect()
        torch.cuda.empty_cache()
        log(f"paths {family}: {time.perf_counter() - t0:.1f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved after freeing the model")
        if torch.cuda.memory_reserved() > RESERVED_LIMIT:
            raise AssertionError(f"{family}: more than 8 GiB reserved after freeing the model")

    # ---- the replay mesh's waves and experts: each zeroes the counts just
    # before its sharded runs and reads them just after
    t0 = time.perf_counter()
    mesh["waves"] = mesh_waves(kernels)
    runs["mesh waves"] = mesh["waves"].pop("launches")
    mesh["experts"] = mesh_experts(kernels)
    runs["mesh experts"] = mesh["experts"].pop("launches")
    log(f"paths mesh waves and experts: {time.perf_counter() - t0:.1f} s")

    # ---- the families: each model's path zeroes the counts just before it
    # and reads them just after (serve_path)
    families = run_families(kernels, registry)
    for arch, fam in families.items():
        runs[arch] = {k: fam["launches"]["prefill"][k] + fam["launches"]["decode"][k]
                      for k in fam["launches"]["prefill"]}
        replayed[arch] = fam["replayed"]

    # ---- the cluster path: counts zeroed just before, read just after (run_cluster)
    cluster = run_cluster(kernels, card)
    runs["cluster"] = cluster.pop("launches")
    log(f"path cluster: launches {runs['cluster']}")

    # the distributed phase's dry-runs take minutes of host time on meta
    # tensors: a child process runs them beside the taskgraph, training and
    # distributed drives, and the distributed phase collects them
    dryrun = start_dryrun()
    try:
        # ---- the taskgraph path: counts zeroed just before, read just after
        for mod in kernels.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        taskgraph = run_taskgraph(kernels, card)
        runs["taskgraph"] = read_counts(kernels)
        # ---- end of the taskgraph path
        log(f"path taskgraph: {len(taskgraph)} runs in {time.perf_counter() - t0:.1f} s; "
            f"launches {runs['taskgraph']}")

        # ---- the training path: counts zeroed just before, read just after
        for mod in kernels.values():
            mod.reset_launches()
        training = run_training(kernels, registry, card)
        runs["train"] = read_counts(kernels)
        # ---- end of the training path
        log(f"path train: launches {runs['train']}")
        for kernel in ("rmsnorm_sm90", "flash_attention_sm90", "ssd_chunk_sm90"):
            if not runs["train"][kernel] > 0:
                raise AssertionError(f"{kernel} never launched on the training path")

        # ---- the distributed paths: each drive zeroes the counts just
        # before its main path and reads them just after
        distributed = run_distributed(kernels, registry, card, dryrun)
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.communicate()
    runs["pipeline"] = distributed["pipeline"]["launches"]
    runs["mesh train"] = distributed["mesh_train"]["launches"]
    log(f"paths pipeline and mesh train: launches {runs['pipeline']}, {runs['mesh train']}")
    first_launched = {label: {k: counts[k] for k in FIRST_DESIGNS if counts[k]}
                      for label, counts in runs.items()}
    first_launched = {label: c for label, c in first_launched.items() if c}
    if first_launched:
        raise AssertionError(f"first designs launched on a path: {first_launched}")
    log(f"first designs {FIRST_DESIGNS}: 0 launches on every path ({', '.join(runs)})")
    # the f32 attention kernel shares its source (and count) with the bf16
    # one: its own launches are the taskgraph's f32 attention runs'
    f32_attention = sum(r["launches_in_capture"]["flash_attention_sm90"] for r in taskgraph
                        if r["workload"].startswith("attention") and "float32" in r["workload"])

    for e in entries:
        src = Path(e["source"]).stem
        e["launches_by_path"] = {label: counts[src] for label, counts in runs.items()}
        symbol = {"rmsnorm_sm90": "rmsnorm_sm90_kernel", "rmsnorm": "rmsnorm_kernel",
                  "grouped_matmul_sm90": "gmm_sm90_kernel"}.get(src)
        e["decode_round_replay_launches"] = {   # one profiled round, from its trace
            label: r[symbol] for label, r in replayed.items() if symbol in r}
        e["launches"] = sum(e["launches_by_path"].values())
        if e["dtype"] == "float32" and src == "flash_attention_sm90":
            e["launches_f32_taskgraph_capture"] = f32_attention
            if not f32_attention > 0:
                raise AssertionError("the f32 attention kernel never launched on the taskgraph path")
        if not e["launches"] > 0:
            raise AssertionError(f"{e['name']} never launched on the main path")
    log(f"total {time.perf_counter() - t_start:.1f} s after the device check")
    log(json.dumps({"kernels": entries, "card": card}))
    log(json.dumps({"taskgraph": taskgraph, "card": card}))
    log(json.dumps({"training": training, "card": card}))
    log(json.dumps({"families": families, "card": card}))
    log(json.dumps({"cluster": cluster}))
    log(json.dumps({"mesh": mesh, "card": card}))
    log(json.dumps({"distributed": distributed, "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
