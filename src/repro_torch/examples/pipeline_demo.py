"""Pipeline parallelism from the pipeline TDG.

Port of ``examples/pipeline_demo.py``. Shows the static 1F1B schedule that
the Taskgraph scheduler emits (the pipeline schedule IS a TDG), then runs a
4-stage GPipe forward + backward through ``core.pipeline.pipeline_apply``
and verifies it against the sequential model. The 4 stages are virtual
positions of one device, from an explicit list (``ReplayMesh((4,),
("stage",), [device] * 4)``): one controller drives them in the TDG's
waves.

Run on the card:  PYTHONPATH=src python -m repro_torch.examples.pipeline_demo
Run on the CPU:   add ``--device cpu`` (without a card and without it, it raises).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import list_schedule, one_f_one_b_order, pipeline_tdg, topo_waves
from repro_torch.core.pipeline import bubble_fraction, pipeline_apply, pipeline_waves
from repro_torch.launch.mesh import ReplayMesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the stages run (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the demo runs on the card unless "
                           "--device cpu is given")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32

    S, M = 4, 8
    tdg = pipeline_tdg(S, M)
    print(tdg.summary())
    waves = topo_waves(tdg)
    print(f"waves: {len(waves)} (fwd+bwd), "
          f"GPipe bubble fraction: {bubble_fraction(S, M):.2f}")
    print("1F1B stage streams:")
    for s, stream in enumerate(one_f_one_b_order(S, M)):
        print(f"  stage{s}: " + " ".join(f"{p}{m}" for p, m in stream))
    sched = list_schedule(tdg, n_workers=S)
    print(f"list-schedule makespan {sched.makespan:.0f} "
          f"(critical path bound: {len(waves)})")

    mesh = ReplayMesh((S,), ("stage",), [args.device] * S)
    d, mb = 32, 4
    gen = torch.Generator(args.device).manual_seed(0)
    Ws = (torch.randn(S, d, d, generator=gen, device=args.device) * 0.3).requires_grad_()
    xs = torch.randn(M, mb, d, generator=gen, device=args.device)

    def stage_fn(W, x):
        return torch.tanh(x @ W)

    def sequential(W):
        out = xs
        for s in range(S):
            out = stage_fn(W[s], out)
        return out

    out = pipeline_apply(stage_fn, Ws, xs, mesh)
    torch.testing.assert_close(out, sequential(Ws), atol=1e-5, rtol=1e-5)
    (g,) = torch.autograd.grad((out ** 2).sum(), Ws)
    (g_ref,) = torch.autograd.grad((sequential(Ws) ** 2).sum(), Ws)
    torch.testing.assert_close(g, g_ref, atol=1e-4, rtol=1e-4)
    print(f"{pipeline_waves(S, M)} forward waves over {S} virtual stages on "
          f"{mesh.devices[0]}")
    print("pipeline forward+backward == sequential: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
