"""Mamba-2 SSD chunked scan: wrapper of ``csrc/ssd_chunk_sm90.cu`` and
``csrc/ssd_chunk.cu``, and the full :func:`ssd` around them.

Replaces ``repro.kernels.ssd_scan`` (see the source notes in the ``.cu``
files for the bounds and the designs). The intra-chunk pass is the custom
op ``repro_torch::ssd_intra_chunk`` (CUDA tensors launch a kernel or raise;
CPU tensors take :func:`ref.ssd_intra_chunk_ref`); its vmap rule folds the
vmapped dim into the batch·head rows, and its autograd formula is the plain
rule :func:`ref.ssd_intra_chunk_bwd_ref`. Which kernel a CUDA call launches
depends on its shape and on whether its inputs start on 16-byte boundaries
(:func:`kernel_for`). :func:`ssd` does the rest
in plain torch, as the reference does in ``jnp``: the layout change, the
inter-chunk recurrence (a Python loop over the chunks where the reference
has a ``lax.scan``), the cross-chunk correction and the ``D`` skip. A
ragged S is padded with dt = 0 steps (:func:`ref.pad_ragged`).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from ._autograd import cuda_op, differentiable, needs_grad
from .ref import pad_ragged, ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref

MAX_CHUNK = 128
MAX_HEADDIM = 128
MAX_SMEM = 232448          # bytes of shared memory a block may have on the H100

#: The kernels, by source: 3xTF32 tensor cores fed by cp.async (head dim
#: <= 64, P and N multiples of 4, within shared memory, 16-byte aligned
#: inputs) and the first design (f32 CUDA cores; any P <= 128).
KERNELS = ("ssd_chunk_sm90", "ssd_chunk")
SM90_MAX_HEADDIM = 64

#: Kernel launches since the last reset (one per launch, nowhere else):
#: the total, and by kernel.
launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0
        for name in KERNELS:
            launches_by_kernel[name] = 0


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.library(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(chunk: int, P: int, N: int, kernel: str = KERNELS[1]) -> int:
    """Shared memory a block of ``kernel`` needs (its launcher uses the same sum).

    ``ssd_chunk_sm90`` (tiles fixed at 128 steps by 64 head columns, N
    padded to a multiple of 32): B, C·Bᵀ, the next head's xs, then C or
    this head's xs as TF32 hi and lo planes, rows of cumulative sums for
    the 4 heads a block takes, and 1024 bytes to align the planes.
    ``ssd_chunk``: B (padded) and C·Bᵀ of the chunk, then C or (xs and one
    64-row score tile) in one buffer, cums and dte."""
    Q = chunk
    if kernel == KERNELS[0]:
        Np = -(-N // 32) * 32
        return 4 * (128 * Np + 128 * 128 + 128 * 64 + max(128 * Np, 2 * 128 * 64)
                    + 4 * 128) + 1024
    return 4 * (Q * (N + 1) + Q * (Q + 1) + max(Q * N, Q * P + 64 * (Q + 1)) + 2 * Q)


def kernel_for(P: int, N: int, chunk: int, aligned: bool = True) -> str:
    """The kernel a CUDA call with head dim P, state N and this chunk
    launches: the tensor-core kernel where its tiles take the shape (P <=
    64, P and N multiples of 4 for its 16-byte copies, and its shared
    memory within the H100's; every served shape and the reference's test
    cases) and xs, b and c start on 16-byte boundaries (``aligned``), else
    the first design."""
    if (aligned and 1 <= chunk <= MAX_CHUNK and 1 <= P <= SM90_MAX_HEADDIM and P % 4 == 0
            and N >= 1 and N % 4 == 0
            and smem_bytes(chunk, P, N, KERNELS[0]) <= MAX_SMEM):
        return KERNELS[0]
    return KERNELS[1]


def _check(xs, b, c, lda, chunk: int) -> None:
    if xs.dim() != 3 or b.dim() != 3 or b.shape != c.shape or lda.shape != xs.shape[:2]:
        raise ValueError(f"want xs (BH, S, P), b = c (BG, S, N), lda (BH, S); got "
                         f"{tuple(xs.shape)}, {tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(lda.shape)}")
    (BH, S, P), (BG, Sb, N) = xs.shape, b.shape
    if Sb != S or BG == 0 or BH % BG:
        raise ValueError(f"b/c rows {BG} x {Sb} do not fit xs {BH} x {S} (BH % BG == 0)")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"SSD kernel takes 1 <= chunk <= {MAX_CHUNK} dividing S; "
                         f"got chunk {chunk}, S {S}")
    if not 1 <= P <= MAX_HEADDIM:
        raise ValueError(f"SSD kernel takes head dim 1..{MAX_HEADDIM}, got {P}")
    kernel = kernel_for(P, N, chunk, _aligned(xs, b, c))
    if smem_bytes(chunk, P, N, kernel) > MAX_SMEM:
        raise ValueError(f"SSD kernel {kernel}: chunk {chunk}, P {P}, N {N} need "
                         f"{smem_bytes(chunk, P, N, kernel)} bytes of shared memory "
                         f"(> {MAX_SMEM})")
    tensors = (xs, b, c, lda)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("SSD kernel takes float32 xs, b, c and lda")
    if any(t.device != xs.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("SSD kernel needs xs, b, c and lda on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("SSD kernel needs contiguous xs, b, c and lda")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _empty_outputs(xs, b, chunk):
    BH, S, P = xs.shape
    nc, N = S // chunk, b.shape[2]
    return (xs.new_empty((BH, S, P)), xs.new_empty((BH, nc, N, P)),
            xs.new_empty((BH, nc, 1, 1)))


def launch_kernel(name: str, xs, b, c, lda, chunk: int):
    """Launch kernel ``name`` (one of :data:`KERNELS`) once on checked,
    non-empty inputs and return (y, state, cdecay). Counts nothing: the
    custom op counts its own launches, and a caller that times or compares
    a kernel through this function stays out of the counts."""
    y, state, cdecay = _empty_outputs(xs, b, chunk)
    BH, S, P = xs.shape
    args = [xs.data_ptr(), b.data_ptr(), c.data_ptr(), lda.data_ptr(), y.data_ptr(),
            state.data_ptr(), cdecay.data_ptr(), BH, S, chunk, P, b.shape[2],
            BH // b.shape[0]]
    if name == KERNELS[0] and not _aligned(xs, b, c):
        raise ValueError(f"{name} needs 16-byte aligned xs, b and c (cp.async)")
    err = _launcher(name)(*args, torch.cuda.current_stream(xs.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return y, state, cdecay


@cuda_op("repro_torch::ssd_intra_chunk")
def _ssd_intra_chunk_cuda(xs: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          lda: torch.Tensor, chunk: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    _check(xs, b, c, lda, chunk)
    if xs.numel() == 0:
        y, state, cdecay = _empty_outputs(xs, b, chunk)
        return y, state.zero_(), cdecay.zero_()
    name = kernel_for(xs.shape[2], b.shape[2], chunk, _aligned(xs, b, c))
    out = launch_kernel(name, xs, b, c, lda, chunk)
    with _count_lock:
        launches += 1
        launches_by_kernel[name] += 1
    return out


@torch.library.register_fake("repro_torch::ssd_intra_chunk")
def _(xs, b, c, lda, chunk):
    return _empty_outputs(xs, b, chunk)


@torch.library.register_vmap("repro_torch::ssd_intra_chunk")
def _(info, in_dims, xs, b, c, lda, chunk):
    n = info.batch_size

    def fold(t, dim):   # (n, R, ...) -> (n * R, ...)
        t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
        return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()

    outs = _ssd_intra_chunk_cuda(fold(xs, in_dims[0]), fold(b, in_dims[1]),
                                 fold(c, in_dims[2]), fold(lda, in_dims[3]), chunk)
    return tuple(o.reshape(n, o.shape[0] // n, *o.shape[1:]) for o in outs), (0, 0, 0)


def _setup_context(ctx, inputs, output):
    xs, b, c, lda, chunk = inputs
    ctx.save_for_backward(xs, b, c, lda)
    ctx.chunk = chunk


def _backward(ctx, gy, gstate, gcdecay):
    return (*ssd_intra_chunk_bwd_ref(*ctx.saved_tensors, ctx.chunk, gy, gstate, gcdecay),
            None)


_SSDIntraChunk = differentiable(_ssd_intra_chunk_cuda, _setup_context, _backward)


def ssd_intra_chunk(xs: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    lda: torch.Tensor, chunk: int):
    """CUDA tensors launch the kernel (or raise); CPU tensors take the plain version."""
    if xs.device.type == "cuda":
        if needs_grad(xs, b, c, lda):
            return _SSDIntraChunk.apply(xs, b, c, lda, chunk)
        return _ssd_intra_chunk_cuda(xs, b, c, lda, chunk)
    return ssd_intra_chunk_ref(xs, b, c, lda, chunk)


def _rows_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, K, ...) -> (B·K, S, ...), contiguous."""
    t = t.movedim(2, 1)
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


def ssd(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)
    A: torch.Tensor,     # (H,)
    Bm: torch.Tensor,    # (B, S, G, N)
    Cm: torch.Tensor,    # (B, S, G, N)
    D: torch.Tensor | None = None,
    init_state: torch.Tensor | None = None,   # (B, H, P, N)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SSD: the intra-chunk kernel plus plain-torch inter-chunk work.
    Matches ``ref.ssd_ref``; returns (y (B, S, H, P) in x's dtype, final
    state (B, H, P, N) f32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"{H} heads not a multiple of {G} groups")
    rep = H // G
    chunk = min(chunk, S)
    if chunk == 0:   # empty sequence: the state passes through
        h0 = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
              if init_state is None else init_state.float())
        return x.new_zeros(x.shape), h0
    xp, dtp, Bp, Cp = pad_ragged(chunk, x, dt, Bm, Cm)
    Sp = xp.shape[1]
    nc, BH = Sp // chunk, Bsz * H

    dtf = dtp.float()
    xs = _rows_first(xp.float() * dtf[..., None])          # (BH, Sp, P)
    bg = _rows_first(Bp.float())                           # (BG, Sp, N)
    cg = _rows_first(Cp.float())
    lda = _rows_first(dtf * A.float()[None, None, :])      # (BH, Sp)
    y_intra, state_local, cdecay = ssd_intra_chunk(xs, bg, cg, lda, chunk)

    # inter-chunk recurrence (nc sequential steps over (BH, N, P))
    h = (torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float().transpose(2, 3).reshape(BH, N, P))
    cd = torch.exp(cdecay[..., 0, 0])                      # (BH, nc)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h)
        h = cd[:, ci, None, None] * h + state_local[:, ci]
    h_prev = torch.stack(h_prevs, dim=1).reshape(Bsz, G, rep, nc, N, P)

    # cross-chunk output: y[i] += exp(cums[i]) * C[i] @ h_prev(chunk(i))
    cums = torch.cumsum(lda.reshape(BH, nc, chunk), dim=2).reshape(Bsz, G, rep, nc, chunk)
    c_c = cg.reshape(Bsz, G, nc, chunk, N)
    y_inter = torch.einsum("bgcin,bgrcnp,bgrci->bgrcip", c_c, h_prev, torch.exp(cums))
    y = y_intra + y_inter.reshape(BH, Sp, P)

    y = y.reshape(Bsz, H, Sp, P).movedim(1, 2)[:, :S]     # (B, S, H, P)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    hT = h.reshape(Bsz, H, N, P).transpose(2, 3).contiguous()   # (B, H, P, N)
    return y.to(x.dtype), hT
