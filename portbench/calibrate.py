"""The readings a cell's limit is set from, many seeds in one process.

    python3 portbench/calibrate.py --workload glm4-gen --seconds 30 \\
        --seeds 11 12 13 --control 3

Set-up runs once; for each seed the weights are drawn again in place (the
captured graphs read them where they are), a window of the cell's own
traffic runs as in ``run.py``, and its sample of served tokens is held to
the reference and judged by ``check.compare`` against the cell's limits
file, as a run is. The first ``--control`` seeds also read the control: the
reference in float8 (W8A8) in the program's place, on the same tokens,
judged the same way (``control_correct``). One JSON line a seed; the
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)
sys.path.insert(1, str(REPO / "src"))

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench import weights as W  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda:0")
    system = harness.System(cell, args.seeds[0], device)
    system.warm()
    ref = check.reference(cell.config)
    B = cell.traffic["sequences"]
    for i, seed in enumerate(args.seeds):
        W.fill(system.buffer, system.layout, seed)
        win = harness.drive(system, seed, args.seconds)
        picks = check.sample(win.served, seed, B, cell.traffic["check_sequences"])
        check.prune(win.served, picks)
        control = "fp8" if i < args.control else None
        gaps, low = check.gaps(ref, cell.model, system.weights, picks, control)
        line = {"workload": args.workload, "seed": seed, "failed": win.failed,
                "tokens": gaps.numel(), "flipped": int((gaps > 0).sum()),
                "captures_in_window": win.captures[1] - win.captures[0],
                "correct": check.compare(gaps, win.failed, cell.limits)[0]}
        line.update({n: read(gaps) for n, read in check.READINGS.items() if gaps.numel()})
        if low is not None:
            # The control in the program's place, judged as run.py judges a run.
            line["control_correct"] = check.compare(low, 0, cell.limits)[0]
            line.update({f"control_{n}": read(low) for n, read in check.READINGS.items()
                         if low.numel()})
            line["control_flipped"] = int((low > 0).sum())
        print(json.dumps(line), flush=True)
        del win, picks
    system.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
