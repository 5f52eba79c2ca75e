"""Flash attention forward: wrapper of ``csrc/flash_attention_sm90.cu`` and
``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention`` (see the source
notes in the ``.cu`` files for the bounds and the designs). CUDA tensors
launch a kernel through the ``repro_torch::flash_attention`` custom op,
whose vmap rule folds the vmapped dim into the batch and whose autograd
formula is the plain backward rule :func:`ref.attention_bwd_ref` (the
probabilities recomputed from q, k and v); CPU tensors take
:func:`ref.attention_ref`. Which kernel a CUDA call launches depends on its
dtype and head dim alone (:func:`kernel_for`).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from ._autograd import differentiable, needs_grad
from .ref import attention_bwd_ref, attention_ref

HEAD_DIMS = (16, 32, 64, 128)
SM90_HEAD_DIMS = (64, 128)
#: The kernels, by source: TMA + wgmma (bf16, head dim 64 / 128) and SIMT.
KERNELS = ("flash_attention_sm90", "flash_attention")
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


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches.

    bf16 at head dim 64 or 128 takes the TMA + wgmma kernel. f32 stays on
    the SIMT kernel, since its parity checks need 2e-5, which TF32 products
    cannot give, and so do head dims 16 and 32.
    """
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return KERNELS[0]
    return KERNELS[1]


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.library(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window: int, chunk: int, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,Hq,D), k = v (B,Sk,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on "
                         f"batch or head_dim, or Hq is not a multiple of Hkv")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes one of float32/bfloat16 for "
                        f"q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device or t.device.type != "cuda" for t in (q, k, v)):
        raise ValueError("flash attention kernel needs q, k, v on one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs contiguous, 16-byte aligned q, k, v")
    if q_offset < 0 or chunk < 0 or window < -1:
        raise ValueError(f"bad q_offset {q_offset}, chunk {chunk} or window {window}")


def launch_kernel(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, chunk: int, scale: float,
                  q_offset: int) -> torch.Tensor:
    """Launch kernel ``name`` (one of :data:`KERNELS`) once on checked,
    non-empty inputs and return its output. Counts nothing: the custom op
    counts its own launches, and a caller that times or compares a kernel
    through this function stays out of the counts."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _launcher(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          B, Sq, Sk, Hq, Hkv, D, scale, int(causal), window, chunk,
                          q_offset, _DTYPES[q.dtype],
                          torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: int, chunk: int, scale: float,
                          q_offset: int) -> torch.Tensor:
    """window -1 and chunk 0 switch those masks off."""
    global launches
    _check(q, k, v, window, chunk, q_offset)
    if q.numel() == 0:
        return torch.empty_like(q)
    if k.shape[1] == 0:   # no key at all: every row sums to 0 and outputs 0
        return torch.zeros_like(q)
    name = kernel_for(q.dtype, q.shape[3])
    out = launch_kernel(name, q, k, v, causal, window, chunk, scale, q_offset)
    with _count_lock:
        launches += 1
        launches_by_kernel[name] += 1
    return out


@_flash_attention_cuda.register_fake
def _(q, k, v, causal, window, chunk, scale, q_offset):
    return torch.empty_like(q)


@_flash_attention_cuda.register_vmap
def _(info, in_dims, q, k, v, causal, window, chunk, scale, q_offset):
    n = info.batch_size

    def fold(t, dim):   # (n, B, S, H, D) -> (n * B, S, H, D)
        t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
        return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()

    out = _flash_attention_cuda(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                fold(v, in_dims[2]), causal, window, chunk,
                                scale, q_offset)
    return out.reshape(n, out.shape[0] // n, *out.shape[1:]), 0


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, chunk, scale, q_offset = inputs
    ctx.save_for_backward(q, k, v)
    ctx.masks = dict(causal=causal, window=None if window < 0 else window,
                     chunk=chunk or None, scale=scale, q_offset=q_offset)


def _backward(ctx, gout):
    q, k, v = ctx.saved_tensors
    gq, gk, gv = attention_bwd_ref(q, k, v, gout, **ctx.masks)
    return gq, gk, gv, None, None, None, None, None


_FlashAttention = differentiable(_flash_attention_cuda, _setup_context, _backward)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    chunk: int | None = None, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """CUDA tensors launch a kernel (or raise); CPU tensors take the plain version."""
    if q.device.type != "cuda":
        return attention_ref(q, k, v, causal=causal, window=window, chunk=chunk,
                             scale=scale, q_offset=q_offset)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    op = _FlashAttention.apply if needs_grad(q, k, v) else _flash_attention_cuda
    return op(q, k, v, causal, -1 if window is None else window,
              0 if chunk is None else chunk, float(scale), q_offset)
