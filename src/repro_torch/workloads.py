"""The paper's application kernels as task graphs (port of the region
builders of ``benchmarks/workloads.py``).

Each builder is parameterized by its size and block count (task
granularity) and returns ``(tdg, buffers, verify)``: Cholesky, Heat
(Gauss-Seidel), N-body, AXPY, DOTP, and two workloads whose tasks dispatch
through the kernel registry, ``rmsnorm_blocks`` and ``attention_blocks``
(on CUDA tensors they launch the hand-written RMSNorm and flash-attention
kernels, through their custom ops' vmap rules when a wave is fused).

Every builder takes ``device`` and ``dtype``. Its data is made on the device
from ``torch.Generator(device).manual_seed(s)``, with the reference's seed
``s`` for each workload, and every buffer is cast to ``dtype`` explicitly.
Host-side generation of the GiB-scale inputs a card takes would outweigh
the run itself; the tests feed these same values, as numpy arrays, through
the reference's task graphs. ``verify`` holds an output dict to the
workload's own check at the reference's tolerance (bf16 at the repo's bf16
tolerance, 2e-2); the reference has none for Heat and N-body, so theirs
hold the output to an f64 run of the same payloads.
"""
from __future__ import annotations

from typing import Callable

import torch

from .core import TDG, TaskGraphRegion, tdg_as_function
from .kernels import ops
from .kernels import ref as kref

BF16_TOL = 2e-2


def _normal(seed: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _tiles(a: torch.Tensor, nb: int, dtype, lower: bool):
    bs = a.shape[0] // nb
    return {f"{i}{j}": a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs].to(dtype).contiguous()
            for i in range(nb) for j in range(nb) if j <= i or not lower}


def _against_f64(tdg: TDG, bufs: dict, rtol: float, atol_scale: float) -> Callable:
    """A check of ``out`` against the same payloads run unrolled in f64."""
    def verify(out):
        want = tdg_as_function(tdg)({k: v.double() for k, v in bufs.items()})
        for k, w in want.items():
            torch.testing.assert_close(out[k].double(), w, rtol=rtol,
                                       atol=atol_scale * w.abs().max().item())
    return verify


def cholesky(n: int = 512, nb: int = 8, *, device="cuda", dtype=torch.float32):
    """Blocked Cholesky: POTRF / TRSM / SYRK / GEMM tasks over the lower tiles
    of an SPD matrix ``m mᵀ + n I``."""
    m = _normal(0, (n, n), device, torch.float64)
    spd = m @ m.T
    del m
    spd.diagonal().add_(n)

    def potrf(a):
        return torch.linalg.cholesky_ex(a).L   # no host check of info

    def trsm(lkk, a):                          # a · lkk⁻ᵀ
        return torch.linalg.solve_triangular(lkk, a.T, upper=False).T

    def syrk(a, l):
        return a - l @ l.T

    def gemm(a, l1, l2):
        return a - l1 @ l2.T

    tdg = TDG(f"cholesky[{nb}]")
    for k in range(nb):
        tdg.add_task(potrf, ins=[f"A{k}{k}"], outs=[f"L{k}{k}"])
        for i in range(k + 1, nb):
            tdg.add_task(trsm, ins=[f"L{k}{k}", f"A{i}{k}"], outs=[f"L{i}{k}"])
        for i in range(k + 1, nb):
            tdg.add_task(syrk, ins=[f"A{i}{i}", f"L{i}{k}"], outs=[f"A{i}{i}"])
            for j in range(k + 1, i):
                tdg.add_task(gemm, ins=[f"A{i}{j}", f"L{i}{k}", f"L{j}{k}"],
                             outs=[f"A{i}{j}"])
    bufs = {f"A{ij}": t for ij, t in _tiles(spd, nb, dtype, lower=True).items()}

    def verify(out):
        bs = n // nb
        L = torch.zeros((n, n), dtype=torch.float64, device=spd.device)
        for i in range(nb):
            for j in range(i + 1):
                L[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = out[f"L{i}{j}"]
        torch.testing.assert_close(L, torch.linalg.cholesky(spd), atol=1e-6 * n, rtol=1e-7)

    return tdg, bufs, verify


def heat(n: int = 512, nb: int = 8, iters: int = 2, *, device="cuda",
         dtype=torch.float32):
    """Gauss-Seidel wavefront stencil over an nb x nb block grid."""
    grid = _normal(1, (n, n), device)

    def relax(c, up, left):
        # one Jacobi-ish sweep using already-updated up/left halos (G-S order)
        top = up[-1:, :]
        lft = left[:, -1:]
        padded = torch.cat([top, c], 0)
        padl = torch.cat([lft, c[:, :-1]], 1)
        return 0.25 * (c + padded[:-1] + padl + torch.roll(c, -1, 0))

    def relax_edge(c):
        return 0.25 * (2 * c + torch.roll(c, 1, 0) + torch.roll(c, -1, 0))

    tdg = TDG(f"heat[{nb}]x{iters}")
    for it in range(iters):
        for i in range(nb):
            for j in range(nb):
                if i == 0 or j == 0:
                    tdg.add_task(relax_edge, inouts=[f"B{i}{j}"], name=f"gs{it}.{i}.{j}")
                else:
                    tdg.add_task(relax, ins=[f"B{i-1}{j}", f"B{i}{j-1}"],
                                 inouts=[f"B{i}{j}"], name=f"gs{it}.{i}.{j}")
    bufs = {f"B{ij}": t for ij, t in _tiles(grid, nb, dtype, lower=False).items()}
    return tdg, bufs, _against_f64(tdg, bufs, rtol=1e-5, atol_scale=1e-6)


def nbody(n_particles: int = 2048, nb: int = 8, *, device="cuda",
          dtype=torch.float32):
    """Embarrassingly parallel force computation over particle blocks."""
    pos = _normal(2, (n_particles, 3), device).to(dtype)
    bs = n_particles // nb
    allpos = pos              # a closure constant, on the buffers' device

    def forces(block):
        d = block[:, None, :] - allpos[None, :, :].to(block.dtype)
        r2 = (d * d).sum(-1) + 1e-3
        w = torch.rsqrt(r2) / r2
        return (d * w[..., None]).sum(1)

    tdg = TDG(f"nbody[{nb}]")
    for b in range(nb):
        tdg.add_task(forces, ins=[f"P{b}"], outs=[f"F{b}"], name=f"force{b}")
    bufs = {f"P{b}": pos[b * bs:(b + 1) * bs].clone() for b in range(nb)}
    return tdg, bufs, _against_f64(tdg, bufs, rtol=1e-4, atol_scale=1e-5)


def axpy(n: int = 1 << 22, nb: int = 8, *, device="cuda", dtype=torch.float32):
    x = _normal(3, (2, n), device)
    x, y = x[0].to(dtype), x[1].to(dtype)
    bs = n // nb

    def ax(xb, yb):
        return 2.5 * xb + yb

    tdg = TDG(f"axpy[{nb}]")
    for b in range(nb):
        tdg.add_task(ax, ins=[f"x{b}", f"y{b}"], outs=[f"z{b}"])
    bufs = {}
    for b in range(nb):
        bufs[f"x{b}"] = x[b * bs:(b + 1) * bs].clone()
        bufs[f"y{b}"] = y[b * bs:(b + 1) * bs].clone()

    def verify(out):
        z = torch.cat([out[f"z{b}"] for b in range(nb)])
        torch.testing.assert_close(z, 2.5 * x + y, rtol=1e-5, atol=1e-6)

    return tdg, bufs, verify


def dotp(n: int = 1 << 22, nb: int = 8, *, device="cuda", dtype=torch.float32):
    x = _normal(4, (2, n), device)
    x, y = x[0].to(dtype), x[1].to(dtype)
    bs = n // nb

    def dot(xb, yb):
        return (xb * yb).sum()

    def reduce(*ps):
        return torch.stack(ps).sum()

    tdg = TDG(f"dotp[{nb}]")
    for b in range(nb):
        tdg.add_task(dot, ins=[f"x{b}", f"y{b}"], outs=[f"p{b}"])
    tdg.add_task(reduce, ins=[f"p{b}" for b in range(nb)], outs=["dot"])
    bufs = {}
    for b in range(nb):
        bufs[f"x{b}"] = x[b * bs:(b + 1) * bs].clone()
        bufs[f"y{b}"] = y[b * bs:(b + 1) * bs].clone()

    def verify(out):
        want = torch.dot(x.double(), y.double())
        torch.testing.assert_close(out["dot"].double(), want, rtol=1e-3, atol=0.0)

    return tdg, bufs, verify


def rmsnorm_blocks(n_tokens: int = 8192, d: int = 512, nb: int = 8, depth: int = 2,
                   *, device="cuda", dtype=torch.float32):
    """Chains of fused RMSNorm over token blocks, through ``ops.rmsnorm``:
    the kernel on CUDA tensors (one launch per fused wave, by the custom
    op's vmap rule), the plain version elsewhere. ``dtype`` is x's; the
    weight is f32."""
    x = _normal(5, (n_tokens, d), device).to(dtype)
    w = _normal(50, (d,), device) * 0.1 + 1.0
    bs = n_tokens // nb

    def norm(xb, wv):
        return ops.rmsnorm(xb, wv)

    tdg = TDG(f"rmsnorm[{nb}]x{depth}")
    for it in range(depth):
        for b in range(nb):
            tdg.add_task(norm, ins=[f"x{b}" if it == 0 else f"h{it-1}.{b}", "w"],
                         outs=[f"h{it}.{b}"], name=f"norm{it}.{b}")
    bufs = {f"x{b}": x[b * bs:(b + 1) * bs].clone() for b in range(nb)}
    bufs["w"] = w

    def verify(out):
        h = x
        for _ in range(depth):
            h = kref.rmsnorm_ref(h, w)
        got = torch.cat([out[f"h{depth-1}.{b}"] for b in range(nb)])
        tol = 1e-4 if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(got.float(), h.float(), atol=tol, rtol=tol)

    return tdg, bufs, verify


def attention_blocks(n_seqs: int = 16, seq: int = 128, heads: int = 4,
                     head_dim: int = 64, nb: int = 4, *, device="cuda",
                     dtype=torch.float32):
    """Causal attention over a fixed pool of sequences, through
    ``ops.attention``. Total work is constant; ``nb`` only sets the task
    granularity (sequences per task = n_seqs / nb)."""
    if n_seqs % nb:
        raise ValueError(f"n_seqs {n_seqs} is not a multiple of nb {nb}")
    per = n_seqs // nb
    qkv = _normal(6, (3, nb, per, seq, heads, head_dim), device).to(dtype)

    def attn(q, k, v):
        return ops.attention(q, k, v, causal=True)

    tdg = TDG(f"attention[{nb}]")
    for b in range(nb):
        tdg.add_task(attn, ins=[f"q{b}", f"k{b}", f"v{b}"], outs=[f"o{b}"],
                     name=f"attn{b}")
    bufs = {}
    for b in range(nb):
        bufs[f"q{b}"], bufs[f"k{b}"], bufs[f"v{b}"] = (t.clone() for t in qkv[:, b])

    def verify(out):
        tol = 2e-3 if dtype == torch.float32 else BF16_TOL
        for b in range(nb):
            want = kref.attention_ref(*qkv[:, b], causal=True)
            torch.testing.assert_close(out[f"o{b}"].float(), want.float(),
                                       atol=tol, rtol=tol)

    return tdg, bufs, verify


WORKLOADS = {
    "cholesky": cholesky,
    "heat": heat,
    "nbody": nbody,
    "axpy": axpy,
    "dotp": dotp,
    "rmsnorm": rmsnorm_blocks,
    "attention": attention_blocks,
}


def as_region(tdg: TDG, name: str | None = None) -> TaskGraphRegion:
    """A taskgraph region whose builder spawns ``tdg``'s tasks with their
    clauses, so a workload records and replays through ``@taskgraph``."""
    def spawn(g, **buffers):
        for t in tdg.tasks:
            g.task(t.fn, ins=t.ins, outs=t.outs, name=t.name,
                   cost_hint=t.cost_hint, **t.metadata)

    return TaskGraphRegion(spawn, name=name or tdg.region)
