"""Registry-driven dispatch for the ported ops (port of ``repro.kernels.ops``).

``attention`` and ``rmsnorm`` keep the reference's signatures and resolve
their substrate through :mod:`registry`: ``cuda`` is the hand-written
kernel, ``ref`` the plain PyTorch version, and ``auto`` picks by the input
tensors' device. ``ssd`` and ``grouped_matmul`` come with their model
families (ROADMAP.md, queue B).
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import ref as _ref
from . import registry
from . import rmsnorm as _rms

def _attention_ref(q, k, v, *, causal=True, window=None, chunk=None,
                   scale=None, q_offset=0, q_chunk=2048):
    """Plain attention (``q_chunk`` bounds the reference's XLA path; unused)."""
    del q_chunk
    return _ref.attention_ref(q, k, v, causal=causal, window=window,
                              chunk=chunk, scale=scale, q_offset=q_offset)


def _attention_cuda(q, k, v, *, causal=True, window=None, chunk=None,
                    scale=None, q_offset=0, q_chunk=2048):
    """The flash-attention CUDA kernel (``q_chunk`` is a ref-path knob; unused)."""
    del q_chunk
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               chunk=chunk, scale=scale, q_offset=q_offset)


registry.register("attention", "ref", _attention_ref)
registry.register("attention", "cuda", _attention_cuda)
registry.register("rmsnorm", "ref", _ref.rmsnorm_ref)
registry.register("rmsnorm", "cuda", _rms.rmsnorm)


def attention(q, k, v, *, causal=True, window=None, chunk=None, scale=None,
              q_offset=0, q_chunk=2048):
    return registry.dispatch("attention", q, k, v, causal=causal,
                             window=window, chunk=chunk, scale=scale,
                             q_offset=q_offset, q_chunk=q_chunk)


def rmsnorm(x, w, eps=1e-6, residual=None):
    return registry.dispatch("rmsnorm", x, w, eps=eps, residual=residual)
