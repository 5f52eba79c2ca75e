"""Fused RMSNorm (+ optional residual add): wrapper of ``csrc/rmsnorm_sm90.cu``
and ``csrc/rmsnorm.cu``.

Replaces ``repro.kernels.rmsnorm.rmsnorm`` (see the source notes in the
``.cu`` files for the bounds and the designs). CUDA tensors launch a kernel
through the ``repro_torch::rmsnorm`` custom op, whose vmap rule folds the
vmapped dim into the rows; CPU tensors take :func:`ref.rmsnorm_ref`. Which
kernel a CUDA call launches depends on x's dtype, d and whether its tensors
start on 16-byte boundaries (:func:`kernel_for`).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from ._autograd import differentiable, needs_grad
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

MAX_D = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The kernels, by source: rows held in registers (d a multiple of 16
#: 16-byte vectors, at most MAX_D, 16-byte aligned tensors) and the first
#: design (any d and alignment).
KERNELS = ("rmsnorm_sm90", "rmsnorm")

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


def kernel_for(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel a CUDA call with x of this dtype and rows of length d
    launches: d a multiple of 16 16-byte vectors (128 bf16, 64 f32) and at
    most MAX_D, with x, w and residual on 16-byte boundaries (``aligned``),
    takes the register-resident kernel (every width of the served models:
    128, 1024, 2048); other calls the first design."""
    vec = 16 // dtype.itemsize
    if aligned and 0 < d <= MAX_D and d % (16 * vec) == 0:
        return KERNELS[0]
    return KERNELS[1]


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.library(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, residual: torch.Tensor | None) -> None:
    d = x.shape[-1]
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got x {x.dtype}, w {w.dtype}")
    if w.shape != (d,):
        raise ValueError(f"rmsnorm weight shape {tuple(w.shape)} != ({d},)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm kernel takes 1 <= d <= {MAX_D}, got {d}")
    tensors = [x, w] + ([residual] if residual is not None else [])
    if any(t.device != x.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("rmsnorm kernel needs x, w and residual on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rmsnorm kernel needs contiguous x, w and residual")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def launch_kernel(name: str, x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """Launch kernel ``name`` (one of :data:`KERNELS`) once on checked,
    non-empty inputs and return its output. Counts nothing: the custom op
    counts its own launches, and a caller that times or compares a kernel
    through this function stays out of the counts."""
    out = torch.empty_like(x)
    d = x.shape[-1]
    if name == KERNELS[0] and not _aligned(x, w, out, residual):
        raise ValueError(f"{name} needs 16-byte aligned x, w and residual")
    err = _launcher(name)(x.data_ptr(), residual.data_ptr() if residual is not None else None,
                          w.data_ptr(), out.data_ptr(), x.numel() // d, d, eps,
                          _DTYPES[x.dtype], _DTYPES[w.dtype],
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(), device_types="cuda")
def _rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float,
                  residual: torch.Tensor | None) -> torch.Tensor:
    global launches
    _check(x, w, residual)
    if x.numel() == 0:
        return torch.empty_like(x)
    name = kernel_for(x.dtype, x.shape[-1], _aligned(x, w, residual))
    out = launch_kernel(name, x, w, eps, residual)
    with _count_lock:
        launches += 1
        launches_by_kernel[name] += 1
    return out


@_rmsnorm_cuda.register_fake
def _(x, w, eps, residual):
    return torch.empty_like(x)


@_rmsnorm_cuda.register_vmap
def _(info, in_dims, x, w, eps, residual):
    x_dim, w_dim, _, r_dim = in_dims
    n = info.batch_size

    def front(t, dim):
        if t is None:
            return None
        return (t.movedim(dim, 0) if dim is not None
                else t.expand(n, *t.shape)).contiguous()

    x, residual = front(x, x_dim), front(residual, r_dim)
    if w_dim is not None:   # per-member weights: one launch per member
        w = w.movedim(w_dim, 0)
        return torch.stack([
            _rmsnorm_cuda(x[i], w[i], eps, None if residual is None else residual[i])
            for i in range(n)]), 0
    return _rmsnorm_cuda(x, w, eps, residual), 0   # vmapped dim folds into rows


def _setup_context(ctx, inputs, output):
    x, w, eps, residual = inputs
    ctx.save_for_backward(x, w, residual)
    ctx.eps = eps


def _backward(ctx, gy):
    x, w, residual = ctx.saved_tensors
    gx, gw, gr = rmsnorm_bwd_ref(x, w, gy, ctx.eps, residual)
    return gx, gw, None, gr


_RMSNorm = differentiable(_rmsnorm_cuda, _setup_context, _backward)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA tensors launch the kernel (or raise); CPU tensors take the plain version."""
    if x.device.type == "cuda":
        if needs_grad(x, w, residual):
            return _RMSNorm.apply(x, w, eps, residual)
        return _rmsnorm_cuda(x, w, eps, residual)
    return rmsnorm_ref(x, w, eps=eps, residual=residual)
