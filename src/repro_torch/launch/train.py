"""End-to-end training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 20 --batch 4 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Wires together every substrate: config -> data pipeline -> model ->
AdamW (cosine or WSD) -> the fused train step (params and moments updated in
place) -> async checkpointing -> the fault-tolerant supervisor. ``--smoke``
uses the reduced same-family config. Runs on the CUDA card; ``--device cpu``
is the only way onto the CPU, and with no card and no ``--device cpu`` it
raises. The run must lower its loss (mean of the last 5 steps below the
mean of the first 5), as the reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..checkpoint import Checkpointer
from ..configs import archs, get_config, reduced
from ..data import DataConfig, make_loader
from ..models import model as M
from ..optim import adamw, warmup_cosine, wsd
from ..runtime import RunState, StragglerPolicy, run_with_recovery
from ..training import make_train_step
from .serve import resolve_device


def build(arch: str, smoke: bool, seq: int, batch: int, steps: int,
          lr: float, schedule: str):
    cfg = get_config(arch)
    if smoke:
        cfg = reduced(cfg, num_layers=4, d_model=128, d_ff=256, vocab_size=512)
    cfg = dataclasses.replace(cfg, loss_chunk=0)
    if schedule == "wsd" or (schedule == "auto" and arch == "minicpm-2b"):
        lr_fn = wsd(lr, max(steps // 10, 1), int(steps * 0.7),
                    max(int(steps * 0.2), 1))
    else:
        lr_fn = warmup_cosine(lr, max(steps // 10, 1), steps)
    optimizer = adamw(lr_fn)
    return cfg, optimizer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(archs()), default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["auto", "cosine", "wsd"],
                    default="auto")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def run(argv=None):
    """Train as :func:`main` does; returns (final RunState, report, losses,
    checkpointer) for callers that inspect the run."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, optimizer = build(args.arch, args.smoke, args.seq, args.batch,
                           args.steps, args.lr, args.schedule)
    print(f"arch={cfg.name} family={cfg.family} device={device}")

    gen = torch.Generator(device).manual_seed(args.seed)
    params = M.params_of(M.init_params(cfg, gen))
    print(f"params: {M.param_count(params):,}")
    opt_state = optimizer.init(params)
    step_fn_raw = make_train_step(cfg, optimizer)

    def step_fn(state: RunState, batch):
        b = {"tokens": torch.from_numpy(batch["tokens"]).to(device)}
        p, s, metrics = step_fn_raw(state.params, state.opt_state, b)
        return RunState(p, s, state.step), metrics

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    ckpt = Checkpointer(args.ckpt_dir)
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f}",
                  flush=True)

    t0 = time.time()
    state, report = run_with_recovery(
        step_fn, RunState(params, opt_state, 0),
        data_iter_factory=lambda s: make_loader(dcfg, s),
        num_steps=args.steps, checkpointer=ckpt,
        checkpoint_every=args.ckpt_every, on_metrics=on_metrics,
        straggler_policy=StragglerPolicy())
    dt = time.time() - t0
    first = sum(losses[:5]) / max(len(losses[:5]), 1)
    last = sum(losses[-5:]) / max(len(losses[-5:]), 1)
    print(f"done: {report}  wall={dt:.1f}s  "
          f"loss {first:.3f} -> {last:.3f}")
    assert last < first, "loss did not improve"
    return state, report, losses, ckpt


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
