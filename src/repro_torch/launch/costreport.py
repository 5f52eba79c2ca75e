"""Per-structure cost report: print every adaptive decision with its numbers.

Port of ``repro.launch.costreport``. For a TDG it runs nothing on a
device: it probes each fused wave class's payload on meta tensors exactly
as ``batcher="auto"`` replay does (``core/costmodel.py``) and prints, per
class, the measured flops / bytes / arithmetic intensity and the batcher
they selected (vmap | map | unrolled), plus the thresholds in force. For a
serving occupancy stream it shows the histogram, the boundaries the bucket
tuner would fit, and the pad-lane bill under pow-2 vs fitted ladders.

Run:  PYTHONPATH=src python -m repro_torch.launch.costreport [--json OUT]

The built-in demo covers all three batcher outcomes. The port's probe
counts only matrix products (``FlopCounterMode``), so its memory-bound and
below-break-even classes are a matrix-vector product and a 2x2 product,
where the reference's demo uses a stencil and an add whose flops XLA counts.

Library use::

    from repro_torch.launch.costreport import structure_report, bucket_report
    rep = structure_report(tdg, buffers)        # per-class decisions
    buckets = bucket_report(occupancies, max_batch=16)
"""
from __future__ import annotations

import argparse
import collections
import json
from typing import Any, Iterable, Mapping, Sequence

import torch

from ..core import costmodel as _costmodel
from ..core import fuse as _fuse
from ..core.tdg import TDG


def structure_report(tdg: TDG, buffers: Mapping[str, Any], min_class_size: int = 2,
                     batcher: str = "auto") -> dict:
    """Per-wave-class batcher decisions for ``tdg`` with measured numbers.

    ``buffers`` holds tensors (real or meta) for the region's input slots;
    shapes propagate by evaluation on meta tensors. The decisions are what
    ``batcher="auto"`` replay applies for these shapes: both run
    ``fuse._decide_class`` over the same cost model.
    """
    model = _costmodel.default_model()
    summary = _fuse.plan(tdg, buffers=buffers, min_class_size=min_class_size,
                         batcher=batcher).summary()
    return {
        "region": tdg.region,
        "adaptive": _costmodel.adaptive_enabled(),
        "policy": {
            "plan_key": _costmodel.plan_key(batcher),
            "ridge_flops_per_byte": model.ridge,
            "map_member_bytes_max": model.map_member_bytes,
            "map_total_bytes_min": model.map_total_bytes,
            "unroll_flops_breakeven": model.unroll_flops,
        },
        "tasks": summary["tasks"],
        "waves": summary["waves"],
        "batchers": summary["batchers"],
        "decisions": summary["decisions"],
    }


def bucket_report(occupancies: Iterable[int], max_batch: int, max_buckets: int = 8) -> dict:
    """What the bucket tuner fits for an occupancy stream, with the bill:
    the histogram, the pow-2 ladder, the fitted boundaries, and total pad
    lanes under each."""
    hist = collections.Counter(int(n) for n in occupancies if int(n) >= 2)
    pow2 = _costmodel.pow2_boundaries(max_batch)
    fitted = _costmodel.fit_boundaries(hist, max_buckets) or pow2

    def pad_bill(bounds: Sequence[int]) -> int:
        total = 0
        for occ, cnt in hist.items():
            b = next((x for x in sorted(bounds) if x >= occ), None)
            if b is None:
                b = bounds and max(bounds) or occ
                while b < occ:
                    b *= 2
            total += cnt * (b - occ)
        return total

    return {
        "observations": sum(hist.values()),
        "histogram": {str(k): v for k, v in sorted(hist.items())},
        "pow2_boundaries": pow2,
        "fitted_boundaries": fitted,
        "pad_lanes_pow2": pad_bill(pow2),
        "pad_lanes_fitted": pad_bill(fitted),
    }


# ------------------------------------------------------------------ printing

def print_structure_report(rep: dict) -> None:
    pol = rep["policy"]
    print(f"== {rep['region']}: per-class batcher decisions "
          f"(adaptive={'on' if rep['adaptive'] else 'OFF'}, plan={pol['plan_key']})")
    print(f"   policy: intensity ridge {pol['ridge_flops_per_byte']:g} flops/B | map "
          f"member<= {pol['map_member_bytes_max']}B, batch>= {pol['map_total_bytes_min']}B "
          f"| unroll< {pol['unroll_flops_breakeven']:g} flops")
    for d in rep["decisions"]:
        flops = "?" if d["flops"] is None else f"{d['flops']:g}"
        nbytes = "?" if d["bytes"] is None else f"{d['bytes']:g}"
        inten = "?" if d["intensity"] is None else f"{d['intensity']:g}"
        print(f"   wave {d['wave']} x{d['size']:<3d} -> {d['batcher']:<8s} "
              f"flops={flops:<10s} bytes={nbytes:<10s} int={inten:<8s} ({d['reason']})")


def print_bucket_report(rep: dict) -> None:
    print(f"== occupancy buckets over {rep['observations']} batched steps")
    print(f"   histogram: {rep['histogram']}")
    print(f"   pow-2 ladder  {rep['pow2_boundaries']} -> {rep['pad_lanes_pow2']} pad lanes")
    print(f"   fitted ladder {rep['fitted_boundaries']} -> "
          f"{rep['pad_lanes_fitted']} pad lanes")


# ---------------------------------------------------------------- demo / CLI

def _mm(a, w):
    return a @ w


def _demo_tdgs() -> list[tuple[TDG, dict]]:
    """Three structures, one for each batcher outcome, over meta tensors."""
    def meta(*shape):
        return torch.empty(*shape, device="meta")

    def grid(region: str, ins: tuple[int, ...], w: tuple[int, ...]):
        tdg = TDG(region=region)
        for i in range(8):
            tdg.add_task(_mm, ins=[f"x{i}", "w"], outs=[f"y{i}"])
        return tdg, {**{f"x{i}": meta(*ins) for i in range(8)}, "w": meta(*w)}

    return [grid("demo_compute_bound", (64, 64), (64, 64)),      # 10.7 flops/B: vmap
            grid("demo_memory_bound", (1, 128), (128, 128)),     # mat-vec: map
            grid("demo_below_breakeven", (2, 2), (2, 2))]        # 8 x 16 flops: unrolled


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the full report as JSON")
    args = ap.parse_args(argv)

    doc: dict = {"structures": [], "buckets": None}
    for tdg, bufs in _demo_tdgs():
        rep = structure_report(tdg, bufs)
        doc["structures"].append(rep)
        print_structure_report(rep)

    # A skewed occupancy stream (stragglers pin most steps at 5 or 12):
    # pow-2 rounds them to 8 and 16; the fitted ladder lands on the modes.
    occupancies = [5] * 40 + [12] * 30 + [3] * 10 + [16] * 5
    rep = bucket_report(occupancies, max_batch=16)
    doc["buckets"] = rep
    print_bucket_report(rep)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
