"""Batched serving example: prefill + greedy decode with per-layer KV/SSM
caches, for the dense, MoE and SSM families.

Port of ``examples/serve_lm.py``. Single-stream by default; pass
``--server`` to drive the decode-step region through the multi-tenant
``repro_torch.serving.RegionServer`` instead: N tenants with private caches
and a shared parameter set, whose structurally identical per-token decode
requests are batched continuously into one replay a step (queue, occupancy,
latency, trace and graph metrics are printed at the end). Runs the reduced
config of ``--arch``.

Run on the card:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch mamba2-370m]
                  PYTHONPATH=src python -m repro_torch.examples.serve_lm --server --tenants 4
Run on the CPU:   add ``--device cpu`` (without a card and without it, it raises).
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--server", action="store_true",
                    help="multi-tenant RegionServer decode (repro_torch.serving)")
    ap.add_argument("--tenants", type=int, default=4)
    args = ap.parse_args(argv)
    forward = ["--arch", args.arch, "--smoke", "--batch", str(args.batch),
               "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
               "--device", args.device]
    if args.server:
        forward += ["--server", "--tenants", str(args.tenants)]
    return serve_mod.main(forward)


if __name__ == "__main__":
    raise SystemExit(main())
