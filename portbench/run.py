"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload glm4-gen --seed 7 --seconds 30 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. The run makes the weights on the card from ``--seed``, warms
every graph the traffic needs, measures ``--seconds`` of closed-loop
serving, checks a sample of the served tokens against the plain reference,
and prints one JSON line: ``--trace 0`` the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from the same window with the device
trace of its last seconds. It exits non-zero, printing no result, without
enough CUDA cards, or when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import sys
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)                  # the package, not its modules, by name
sys.path.insert(1, str(REPO / "src"))

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench.trace import Tracer  # noqa: E402


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def load_reader(name: str):
    """A per-layer metric's reader, ``metrics/<name>.py``."""
    return harness.load_file(harness.PKG / "metrics" / f"{name}.py").read


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def end_to_end(r: harness.Readings, setup_s: float) -> dict:
    B = r.traffic["sequences"]
    events = list(harness.token_events(r.win, B))
    gaps = [g for _, n, _, g, _ in events if g is not None for _ in range(n)]
    return {"tok_s": sum(n for _, n, *_ in events) / r.win.seconds,
            "tpot_p95_ms": harness.nearest_rank(gaps, 95) * 1e3 if gaps else None,
            "setup_s": setup_s}


def breakdown(r: harness.Readings) -> dict:
    tr = r.trace
    by_name: dict[str, float] = {}
    for k in tr.kernels:
        by_name[k.name[:64]] = by_name.get(k.name[:64], 0.0) + \
            min(k.end, tr.t_stop) - max(k.start, tr.t_start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for lo, hi in tr.idle_gaps():
        label = ("prefill" if r.prefill_at(lo) else
                 "decode_step" if r.step_at(lo) else "between_steps")
        gaps.append([label, hi - lo])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps[:10]}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device) -> tuple[dict, list[tuple]]:
    """The result line's fields, and the numbers compared with their limits."""
    tracer = Tracer(cell.traffic["trace_seconds"]) if trace else None
    system = harness.System(cell, seed, device)
    warm = system.warm()
    if device.type == "cuda":
        warm["allocated_gib"] = torch.cuda.memory_allocated(device) / 2**30
    print(f"portbench: warm {json.dumps(warm)}", file=sys.stderr)
    win = harness.drive(system, seed, seconds, tracer)
    age = harness.process_age()
    setup_s = (age if age is not None else time.monotonic() - T_START) \
        - (time.monotonic() - win.t_open)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    readings = harness.Readings(cell, cell.model, cell.traffic, win,
                                tracer.read() if trace and tracer.started else None,
                                harness.peaks(device))
    steps = harness.steps_in_window(win)
    print("portbench: window " + json.dumps({
        "steps": len(steps), "captures": win.captures[1] - win.captures[0],
        "occupancy": sum(r["occupancy"] for r in steps) / max(1, len(steps)),
        "step_ms": sum(r["wall_ms"] for r in steps) / max(1, len(steps)),
        "prefills": sum(1 for _, t1, _ in harness.prefills_in(win) if win.inside(t1)),
        "done": sum(s.done for s in win.served), "setup_s": setup_s}), file=sys.stderr)
    if trace:
        metrics = {m["name"]: load_reader(m["name"])(readings) for m in cell.metrics("per_layer")}
    else:
        e2e = end_to_end(readings, setup_s)
        metrics = {m["name"]: e2e.get(m["name"]) for m in cell.metrics("end_to_end")}
    units = {m["name"]: m["unit"] for m in cell.metrics("per_layer" if trace else "end_to_end")}
    result = {"correct": False, "attempted": win.attempted, "failed": win.failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items() if v is not None},
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu",
                         "count": cell.entry["chips"], "memory_peak_bytes": peak}}
    if trace and readings.trace is not None:
        tr = readings.trace
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = breakdown(readings)

    # The program's state goes before the reference runs; the weights stay.
    B = cell.traffic["sequences"]
    picks = check.sample(win.served, seed, B, cell.traffic["check_sequences"])
    check.prune(win.served, picks)
    weights, model = system.weights, cell.model
    system.close()
    del system, readings
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    ref = check.reference(cell.config)
    gaps, _ = check.gaps(ref, model, weights, picks)
    print(f"portbench: reference {time.monotonic() - t_ref:.1f} s over {len(picks)} rows",
          file=sys.stderr)
    result["correct"], compared = check.compare(gaps, win.failed, cell.limits)
    if win.errors:
        print(f"portbench: a client failed: {win.errors[0]!r}", file=sys.stderr)
    result["check"] = {n: {"value": v, "limit": L} for n, v, L, _ in compared}
    return result, compared


#: A run that has not printed its result by then ends, with no result.
DEADLINE_S = 330


def _expire() -> None:
    print(f"portbench: no result within {DEADLINE_S} s", file=sys.stderr, flush=True)
    os._exit(5)


def main(argv=None) -> int:
    watchdog = threading.Timer(DEADLINE_S - (time.monotonic() - T_START), _expire)
    watchdog.daemon = True
    watchdog.start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        return _fail("--seed must be a whole number >= 0", 2)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"forbidden modules loaded at start: {bad}", 4)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        return _fail(f"{args.workload} needs {cell.entry['chips']} CUDA card(s); "
                     f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    result, compared = run(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda:0"))
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"forbidden modules loaded after the window: {bad}", 4)
    result["device"]["power_limit"] = power_limit()
    for name, value, limit, op in compared:
        print(f"check {name} {value} {op} {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    watchdog.cancel()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
