"""Registry-driven dispatch for the ported ops (port of ``repro.kernels.ops``).

``attention``, ``ssd``, ``grouped_matmul`` and ``rmsnorm`` keep the
reference's signatures and resolve their substrate through
:mod:`registry`: ``cuda`` is the hand-written kernel (for ``ssd``, the
intra-chunk kernel inside :func:`ssd_scan.ssd`), ``ref`` the plain PyTorch
version, and ``auto`` picks by the input tensors' device.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import moe_gmm as _gmm
from . import ref as _ref
from . import registry
from . import rmsnorm as _rms
from . import ssd_scan as _ssd
from . import xla_attention as _xla


def _attention_ref(q, k, v, *, causal=True, window=None, chunk=None,
                   scale=None, q_offset=0, q_chunk=2048):
    """Plain attention with bounded live scores, routed as the reference's.

    The banded forms take self-attention from position 0 only, and the
    reference's routing drops a window or chunk mask that comes without
    causality and any ``q_offset`` that comes with one; those calls take the
    oracle, ``ref.attention_ref``, which applies every mask and offset.
    """
    if (window or chunk) and (not causal or q_offset or q.shape[1] != k.shape[1]):
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  chunk=chunk, scale=scale, q_offset=q_offset)
    if not causal:
        return _xla.sdpa_cross(q, k, v, scale=scale)
    if window:
        return _xla.sdpa_sliding(q, k, v, window=window, scale=scale)
    if chunk:
        return _xla.sdpa_chunked(q, k, v, chunk=chunk, scale=scale)
    return _xla.sdpa_full(q, k, v, causal=causal, scale=scale,
                          q_offset=q_offset, chunk=q_chunk)


def _attention_cuda(q, k, v, *, causal=True, window=None, chunk=None,
                    scale=None, q_offset=0, q_chunk=2048):
    """The flash-attention CUDA kernel (``q_chunk`` is a ref-path knob; unused)."""
    del q_chunk
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               chunk=chunk, scale=scale, q_offset=q_offset)


def _ssd_ref(x, dt, A, Bm, Cm, D=None, init_state=None, *, chunk=128):
    """Blockwise plain SSD (chunk clamped to the sequence length)."""
    return _ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D=D, init_state=init_state,
                                chunk=min(chunk, x.shape[1]))


registry.register("attention", "ref", _attention_ref)
registry.register("attention", "cuda", _attention_cuda)
registry.register("ssd", "ref", _ssd_ref)
registry.register("ssd", "cuda", _ssd.ssd)
registry.register("grouped_matmul", "ref", _ref.grouped_matmul_ref)
registry.register("grouped_matmul", "cuda", _gmm.grouped_matmul)
registry.register("rmsnorm", "ref", _ref.rmsnorm_ref)
registry.register("rmsnorm", "cuda", _rms.rmsnorm)


def attention(q, k, v, *, causal=True, window=None, chunk=None, scale=None,
              q_offset=0, q_chunk=2048):
    return registry.dispatch("attention", q, k, v, causal=causal,
                             window=window, chunk=chunk, scale=scale,
                             q_offset=q_offset, q_chunk=q_chunk)


def ssd(x, dt, A, Bm, Cm, D=None, init_state=None, *, chunk=128):
    return registry.dispatch("ssd", x, dt, A, Bm, Cm, D=D,
                             init_state=init_state, chunk=chunk)


def grouped_matmul(x, w):
    return registry.dispatch("grouped_matmul", x, w)


def rmsnorm(x, w, eps=1e-6, residual=None):
    return registry.dispatch("rmsnorm", x, w, eps=eps, residual=residual)
