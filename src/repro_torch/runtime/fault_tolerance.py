"""Fault tolerance: recoverable training runs, step timing, stragglers
(port of ``repro.runtime.fault_tolerance``).

At 1000+ nodes the failure model is: some host dies mid-step every few
hours. The contract here:

  * every N steps an async checkpoint is cut (``Checkpointer``);
  * ``run_with_recovery`` executes the step loop inside a supervisor that
    catches step failures (device OOM, preempted host, injected faults in
    tests), restores the last committed checkpoint, rebuilds the data
    iterator at the restored step (deterministic addressing — no data-state
    to save) and resumes;
  * a ``StepTimer`` tracks a running P50/P99; ``StragglerPolicy`` flags
    steps beyond ``k * p50`` — on a real pod this triggers the backup-task
    hook (the work-stealing analogue at cluster scale: re-execute the
    straggler's shard elsewhere); on CPU we surface the signal and count it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


def _wait_for(metrics) -> None:
    """Wait for the device that computed ``metrics`` (the counterpart of
    ``jax.block_until_ready``): a step's time is its device time too."""
    for leaf in pytree.tree_leaves(metrics):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


@dataclasses.dataclass
class RunState:
    params: Any
    opt_state: Any
    step: int = 0


class StepTimer:
    def __init__(self, window: int = 128):
        self.durations: list[float] = []
        self.window = window

    def record(self, seconds: float):
        self.durations.append(seconds)
        if len(self.durations) > self.window:
            self.durations.pop(0)

    def percentile(self, q: float) -> float:
        if not self.durations:
            return 0.0
        s = sorted(self.durations)
        idx = min(len(s) - 1, int(q / 100.0 * len(s)))
        return s[idx]


@dataclasses.dataclass
class StragglerPolicy:
    """Flag steps slower than ``threshold x p50`` once warmed up."""
    threshold: float = 3.0
    warmup_steps: int = 8
    flagged: int = 0

    def check(self, timer: StepTimer, seconds: float) -> bool:
        if len(timer.durations) < self.warmup_steps:
            return False
        p50 = timer.percentile(50)
        if p50 > 0 and seconds > self.threshold * p50:
            self.flagged += 1
            return True
        return False


def run_with_recovery(
    step_fn: Callable[[RunState, dict], tuple[RunState, dict]],
    state: RunState,
    data_iter_factory: Callable[[int], Any],
    num_steps: int,
    checkpointer=None,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    on_metrics: Callable[[int, dict], None] | None = None,
    straggler_policy: StragglerPolicy | None = None,
    fault_injector: Callable[[int], None] | None = None,
) -> tuple[RunState, dict]:
    """Supervised step loop. Returns (final state, run report)."""
    report = {"restarts": 0, "completed_steps": 0, "stragglers": 0,
              "checkpoints": 0}
    timer = StepTimer()
    restarts = 0
    target = state.step + num_steps

    while state.step < target:
        data = data_iter_factory(state.step)
        try:
            while state.step < target:
                batch = next(data)
                if fault_injector is not None:
                    fault_injector(state.step)   # may raise (test hook)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                _wait_for(metrics)
                dt = time.perf_counter() - t0
                timer.record(dt)
                if straggler_policy and straggler_policy.check(timer, dt):
                    report["stragglers"] += 1
                state.step += 1
                report["completed_steps"] += 1
                if on_metrics:
                    on_metrics(state.step, metrics)
                if checkpointer and state.step % checkpoint_every == 0:
                    checkpointer.save(
                        {"params": state.params, "opt_state": state.opt_state,
                         "step": state.step}, state.step)
                    report["checkpoints"] += 1
        except Exception:
            restarts += 1
            report["restarts"] = restarts
            if restarts > max_restarts or checkpointer is None:
                raise
            restored, ck_step = checkpointer.restore(
                {"params": state.params, "opt_state": state.opt_state,
                 "step": 0})
            if restored is None:
                raise
            state = RunState(params=restored["params"],
                             opt_state=restored["opt_state"],
                             step=int(ck_step))
            # data iterator rebuilt at the restored step by the factory
            continue
    if checkpointer is not None:
        checkpointer.wait()
    return state, report
