"""Grouped (per-expert) matmul: wrapper of ``csrc/grouped_matmul_sm90.cu``
and ``csrc/grouped_matmul.cu``.

Replaces ``repro.kernels.moe_gmm.grouped_matmul`` (see the source notes in
the ``.cu`` files for the bounds and the designs). CUDA tensors launch a
kernel through the ``repro_torch::grouped_matmul`` custom op (its autograd
formula: the plain rule :func:`ref.grouped_matmul_bwd_ref`); CPU tensors
take :func:`ref.grouped_matmul_ref`. Which kernel a CUDA call launches
depends on its dtype and shape alone (:func:`kernel_for`). Under
``torch.func.vmap`` with shared weights (the server's coalesced decode) the
vmapped dim folds into C, so one launch serves the whole batch.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from ._autograd import differentiable, needs_grad
from .ref import grouped_matmul_bwd_ref, grouped_matmul_ref

#: The kernels, by source: TMA + wgmma (bf16, d and f multiples of 8) and
#: the first design (mma.sync for bf16, SIMT for f32).
KERNELS = ("grouped_matmul_sm90", "grouped_matmul")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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


def kernel_for(dtype: torch.dtype, d: int, f: int) -> str:
    """The kernel a CUDA call with this dtype and x (E, C, d), w (E, d, f)
    launches: bf16 with d and f positive multiples of 8 (TMA needs 16-byte
    row strides and a non-empty tensor) takes the TMA + wgmma kernel; f32
    and the other shapes the first design."""
    if dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f % 8 == 0:
        return KERNELS[0]
    return KERNELS[1]


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.library(name), f"{name}_launch")
    ints = 4 if name == KERNELS[0] else 7    # E, C, d, f [, dtype, vec_a, vec_b]
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"want x (E, C, d) and w (E, d, f); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped matmul kernel takes one of float32/bfloat16 for x and w; "
                        f"got {x.dtype}, {w.dtype}")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("grouped matmul kernel needs x and w on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped matmul kernel needs contiguous x and w")


def _vec(t: torch.Tensor, row: int) -> int:
    """Rows may be read as 16-byte vectors (bf16: 8 elements)."""
    return int(row % 8 == 0 and t.data_ptr() % 16 == 0)


def launch_kernel(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` (one of :data:`KERNELS`) once on checked,
    non-empty inputs and return its output. Counts nothing: the custom op
    counts its own launches, and a caller that times or compares a kernel
    through this function stays out of the counts."""
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == KERNELS[0]:
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned x and w (TMA)")
        err = _launcher(name)(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f, stream)
    else:
        err = _launcher(name)(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
                              _DTYPES[x.dtype], _vec(x, d), _vec(w, f), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    return out


@torch.library.custom_op("repro_torch::grouped_matmul", mutates_args=(),
                         device_types="cuda")
def _grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    _check(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    if E * C * f == 0:
        return x.new_empty((E, C, f))
    name = kernel_for(x.dtype, d, f)
    out = launch_kernel(name, x, w)
    with _count_lock:
        launches += 1
        launches_by_kernel[name] += 1
    return out


@_grouped_matmul_cuda.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@_grouped_matmul_cuda.register_vmap
def _(info, in_dims, x, w):
    x_dim, w_dim = in_dims
    n = info.batch_size
    x = x.movedim(x_dim, 0) if x_dim is not None else x.expand(n, *x.shape)
    if w_dim is not None:   # per-member weights: one launch per member
        w = w.movedim(w_dim, 0)
        return torch.stack([_grouped_matmul_cuda(x[i].contiguous(), w[i].contiguous())
                            for i in range(n)]), 0
    _, E, C, d = x.shape    # shared weights: (n, E, C, d) -> (E, n * C, d)
    out = _grouped_matmul_cuda(x.movedim(0, 1).reshape(E, n * C, d).contiguous(), w)
    return out.reshape(E, n, C, -1).movedim(1, 0), 0


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, gy):
    return grouped_matmul_bwd_ref(*ctx.saved_tensors, gy)


_GroupedMatmul = differentiable(_grouped_matmul_cuda, _setup_context, _backward)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CUDA tensors launch a kernel (or raise); CPU tensors take the plain version."""
    if x.device.type == "cuda":
        if needs_grad(x, w):
            return _GroupedMatmul.apply(x, w)
        return _grouped_matmul_cuda(x, w)
    return grouped_matmul_ref(x, w)
