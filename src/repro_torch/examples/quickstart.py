"""Quickstart: the Taskgraph framework on blocked Cholesky factorization.

Port of ``examples/quickstart.py``. Blocked Cholesky is the canonical
task-dependency-graph workload (and one of the paper's benchmarks):
POTRF/TRSM/SYRK/GEMM tasks over matrix tiles with a dense dependency web
that vanilla runtimes resolve on every execution.

This example:
  1. declares the region with ``@taskgraph`` (depend-clause style),
  2. runs it once  -> record (executes while building the TDG),
  3. runs it again -> replay (wave-fused, and on the card one captured CUDA
     graph, with no per-task orchestration),
  4. times eager (dynamic per-task dispatch) against replay,
  5. verifies both against ``np.linalg.cholesky``.

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 512 --nb 8]
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import EagerExecutor, taskgraph, topo_waves
from repro_torch.core.record import synchronize


def cholesky_region(nb: int):
    """Build a taskgraph region factoring an (nb x nb)-tile SPD matrix."""

    def potrf(a):
        return torch.linalg.cholesky_ex(a).L   # no host check of info

    def trsm(l_kk, a):                          # A @ L_kk^-T
        return torch.linalg.solve_triangular(l_kk, a.T, upper=False).T

    def syrk(a, l):                             # A - L L^T
        return a - l @ l.T

    def gemm(a, l1, l2):                        # A - L1 L2^T
        return a - l1 @ l2.T

    @taskgraph(name=f"cholesky_{nb}")
    def region(g, **tiles):
        for k in range(nb):
            g.task(potrf, ins=[f"A{k}{k}"], outs=[f"L{k}{k}"], name=f"potrf{k}")
            for i in range(k + 1, nb):
                g.task(trsm, ins=[f"L{k}{k}", f"A{i}{k}"], outs=[f"L{i}{k}"],
                       name=f"trsm{i}{k}")
            for i in range(k + 1, nb):
                g.task(syrk, ins=[f"A{i}{i}", f"L{i}{k}"], outs=[f"A{i}{i}"],
                       name=f"syrk{i}{k}")
                for j in range(k + 1, i):
                    g.task(gemm, ins=[f"A{i}{j}", f"L{i}{k}", f"L{j}{k}"],
                           outs=[f"A{i}{j}"], name=f"gemm{i}{j}{k}")

    return region


def _timed(fn, reps: int) -> tuple[float, dict]:
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    synchronize(out)
    return (time.perf_counter() - t0) / reps, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) needs a card; cpu is the only way onto the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the quickstart runs on the card unless "
                           "--device cpu is given")
    n, nb = args.n, args.nb
    bs = n // nb

    rng = np.random.default_rng(0)
    m = rng.standard_normal((n, n))
    spd = m @ m.T + n * np.eye(n)
    tiles = {f"A{i}{j}": torch.from_numpy(spd[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs])
             .to(device=args.device, dtype=torch.float32)   # f64 in numpy: cast
             for i in range(nb) for j in range(nb) if j <= i}

    region = cholesky_region(nb)

    t0 = time.perf_counter()                    # 1st call records
    out = region(**tiles)
    t_record = time.perf_counter() - t0
    print(f"record : {t_record * 1e3:8.1f} ms   {region.tdg.summary()}")
    waves = topo_waves(region.tdg)
    print(f"         {len(waves)} waves, max width {max(len(w) for w in waves)}")

    region(**tiles)                             # lower (and capture, on the card)
    t_replay, out = _timed(lambda: region(**tiles), args.reps)

    eager = EagerExecutor(region.tdg, n_workers=4)
    eager.run(dict(tiles))
    t_eager, out_e = _timed(lambda: eager.run(dict(tiles)), args.reps)

    where = (torch.cuda.get_device_name(0) if args.device == "cuda" else "CPU")
    print(f"eager  : {t_eager * 1e3:8.1f} ms   (per-task dispatch, "
          f"{eager.stats.queue_ops} queue ops, {eager.stats.steals} steals; {where})")
    print(f"replay : {t_replay * 1e3:8.1f} ms   (fused"
          f"{', one captured CUDA graph' if args.device == 'cuda' else ''})")
    print(f"speedup: {t_eager / t_replay:8.2f}x")

    L = np.zeros((n, n))
    for i in range(nb):
        for j in range(i + 1):
            L[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = out[f"L{i}{j}"].cpu().numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(spd), atol=1e-6 * n)
    for k in out:  # eager (per-task) vs replay (fused): f32 reassociation
        np.testing.assert_allclose(out[k].cpu().numpy(), out_e[k].cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
    print("verified against np.linalg.cholesky — OK")


if __name__ == "__main__":
    main()
