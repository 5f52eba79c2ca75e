"""The backward rules of the port's four custom ops against the references.

Each kernel's custom op differentiates through a plain backward rule
(``ref.*_bwd_ref``, registered by ``setup_context`` / ``_backward`` in its
wrapper module). A CUDA op cannot run here, so each rule is driven through
an ``autograd.Function`` whose forward is the plain version and whose
``setup_context`` / ``backward`` are the ones the op registers, and held to
(a) autograd of the port's plain version, (b) ``jax.vjp`` of the reference's
plain op on the same numpy inputs and cotangents, and (c) ``gradcheck`` in
f64. f32 comparisons use atol = rtol = 1e-4 (two frameworks sum f32
products in different orders). The ops themselves are differentiated on
meta tensors (their fake implementations), under ``torch.autograd.grad``
and ``torch.func.vjp``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TOL = 1e-4


def _rule_function(mod, plain):
    """An autograd.Function: forward ``plain``, backward the rule ``mod`` registers."""
    return type("Rule", (torch.autograd.Function,), {
        "forward": staticmethod(plain),
        "setup_context": staticmethod(mod._setup_context),
        "backward": staticmethod(mod._backward),
    })


RMS = _rule_function(rms, lambda x, w, eps, r: ref.rmsnorm_ref(x, w, eps, r))
GMM = _rule_function(gmm, ref.grouped_matmul_ref)
SSD = _rule_function(ssd, ref.ssd_intra_chunk_ref)


def _attn_plain(q, k, v, causal, window, chunk, scale, q_offset):
    return ref.attention_ref(q, k, v, causal=causal, window=None if window < 0 else window,
                             chunk=chunk or None, scale=scale, q_offset=q_offset)


ATTN = _rule_function(fa, _attn_plain)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _leaves(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


def _grads(fn, arrays, cots, dtype=torch.float32):
    xs = _leaves(arrays, dtype)
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    return [g.detach() for g in torch.autograd.grad(
        outs, xs, [torch.tensor(c, dtype=dtype) for c in cots])]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   atol=tol, rtol=tol)


# ---------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 48)])
def test_rmsnorm_rule(shape, residual):
    rng = np.random.default_rng(0)
    arrays = [_np(rng, *shape), _np(rng, shape[-1])] + ([_np(rng, *shape)] if residual else [])
    gy = _np(rng, *shape)
    if residual:
        rule = _grads(lambda x, w, r: RMS.apply(x, w, 1e-6, r), arrays, [gy])
        plain = _grads(lambda x, w, r: ref.rmsnorm_ref(x, w, residual=r), arrays, [gy])
        _, vjp = jax.vjp(lambda x, w, r: jref.rmsnorm_ref(x, w, residual=r),
                         *map(jnp.asarray, arrays))
    else:
        rule = _grads(lambda x, w: RMS.apply(x, w, 1e-6, None), arrays, [gy])
        plain = _grads(lambda x, w: ref.rmsnorm_ref(x, w), arrays, [gy])
        _, vjp = jax.vjp(jref.rmsnorm_ref, *map(jnp.asarray, arrays))
    _close(rule, plain)
    _close(rule, vjp(jnp.asarray(gy)))


def test_rmsnorm_rule_bf16_dtypes():
    x = torch.randn(4, 32, dtype=torch.bfloat16)
    w = torch.randn(32, dtype=torch.float32)
    gx, gw, gr = ref.rmsnorm_bwd_ref(x, w, torch.randn(4, 32, dtype=torch.bfloat16))
    assert (gx.dtype, gw.dtype, gr) == (torch.bfloat16, torch.float32, None)


# ---------------------------------------------------------------- attention

ATTN_CASES = [  # (B, Sq, Sk, Hq, Hkv, D, causal, window, chunk, q_offset)
    (2, 16, 16, 4, 2, 16, True, -1, 0, 0),          # causal GQA
    (1, 12, 12, 4, 1, 8, True, 4, 0, 0),            # sliding window, MQA
    (1, 16, 16, 2, 2, 8, True, -1, 8, 0),           # chunked-local
    (2, 4, 20, 4, 2, 8, True, -1, 0, 16),           # decode offset
    (1, 10, 14, 2, 1, 8, False, -1, 0, 0),          # cross attention
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_rule(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, chunk, q_offset = case
    rng = np.random.default_rng(1)
    arrays = [_np(rng, B, Sq, Hq, D), _np(rng, B, Sk, Hkv, D), _np(rng, B, Sk, Hkv, D)]
    go = _np(rng, B, Sq, Hq, D)
    scale = D ** -0.5
    kw = dict(causal=causal, window=None if window < 0 else window, chunk=chunk or None,
              q_offset=q_offset)
    rule = _grads(lambda q, k, v: ATTN.apply(q, k, v, causal, window, chunk, scale, q_offset),
                  arrays, [go])
    plain = _grads(lambda q, k, v: ref.attention_ref(q, k, v, **kw), arrays, [go])
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, **kw),
                     *map(jnp.asarray, arrays))
    _close(rule, plain)
    _close(rule, vjp(jnp.asarray(go)))


def _live_rows(Sq, Sk, window, q_offset):
    q_pos, k_pos = q_offset + np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    return ((q_pos >= k_pos) & (q_pos - k_pos < window)).any(1)


def test_attention_rule_fully_masked_row():
    """Decode rows whose window holds no key: the kernel outputs 0 for such
    a row, so the rule lets its cotangent reach nothing. With q_offset 19,
    window 4 and keys 0..19, rows 0..3 (positions 19..22) see keys and rows
    4..7 (23..26) see none; on the live rows the rule is the plain
    gradient, which is the reference's once the dead rows' cotangent is 0
    (the reference's oracle averages v over a fully masked row instead).
    With q_offset 36 every row is dead and every gradient 0."""
    B, Sq, Sk, Hq, Hkv, D = 1, 8, 20, 2, 1, 8
    rng = np.random.default_rng(2)
    arrays = [_np(rng, B, Sq, Hq, D), _np(rng, B, Sk, Hkv, D), _np(rng, B, Sk, Hkv, D)]
    go = _np(rng, B, Sq, Hq, D)
    live = _live_rows(Sq, Sk, 4, 19)
    assert live.tolist() == [True] * 4 + [False] * 4
    go_live = go * live[None, :, None, None]

    def rule(cot, q_offset=19):
        return _grads(lambda q, k, v: ATTN.apply(q, k, v, True, 4, 0, D ** -0.5, q_offset),
                      arrays, [cot])

    got = rule(go)
    _close(got, rule(go_live), tol=0)
    kw = dict(causal=True, window=4, q_offset=19)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, **kw), *map(jnp.asarray, arrays))
    _close(got, vjp(jnp.asarray(go_live)))
    _close(got, _grads(lambda q, k, v: ref.attention_ref(q, k, v, **kw), arrays, [go_live]))
    assert not _live_rows(Sq, Sk, 4, 36).any()
    assert all(g.abs().max() == 0 for g in rule(go, q_offset=36))


# ---------------------------------------------------------------- grouped matmul

@pytest.mark.parametrize("E,C,d,f", [(4, 8, 16, 12), (2, 5, 7, 3)])
def test_grouped_matmul_rule(E, C, d, f):
    rng = np.random.default_rng(3)
    arrays = [_np(rng, E, C, d), _np(rng, E, d, f)]
    gy = _np(rng, E, C, f)
    rule = _grads(GMM.apply, arrays, [gy])
    _close(rule, _grads(ref.grouped_matmul_ref, arrays, [gy]))
    _, vjp = jax.vjp(jref.grouped_matmul_ref, *map(jnp.asarray, arrays))
    _close(rule, vjp(jnp.asarray(gy)))


# ---------------------------------------------------------------- SSD

def _ssd_arrays(rng, BH, BG, S, P, N):
    return [_np(rng, BH, S, P, scale=0.5), _np(rng, BG, S, N, scale=0.5),
            _np(rng, BG, S, N, scale=0.5), -np.abs(_np(rng, BH, S, scale=0.3))]


@pytest.mark.parametrize("BH,BG,S,P,N,chunk", [(4, 2, 32, 8, 4, 16), (6, 3, 24, 4, 8, 8),
                                                (2, 1, 16, 4, 4, 16)])
def test_ssd_intra_chunk_rule(BH, BG, S, P, N, chunk):
    rng = np.random.default_rng(4)
    arrays = _ssd_arrays(rng, BH, BG, S, P, N)
    nc = S // chunk
    cots = [_np(rng, BH, S, P), _np(rng, BH, nc, N, P), _np(rng, BH, nc, 1, 1)]
    rule = _grads(lambda *a: SSD.apply(*a, chunk), arrays, cots)
    plain = _grads(lambda *a: ref.ssd_intra_chunk_ref(*a, chunk), arrays, cots)
    _close(rule, plain)


def test_ssd_intra_chunk_rule_takes_missing_cotangents():
    rng = np.random.default_rng(5)
    xs, b, c, lda = (torch.tensor(a) for a in _ssd_arrays(rng, 2, 1, 16, 4, 4))
    gy = torch.tensor(_np(rng, 2, 16, 4))
    only_y = ref.ssd_intra_chunk_bwd_ref(xs, b, c, lda, 8, gy, None, None)
    zeros = ref.ssd_intra_chunk_bwd_ref(xs, b, c, lda, 8, gy, torch.zeros(2, 2, 4, 4),
                                        torch.zeros(2, 2, 1, 1))
    _close(only_y, zeros, tol=0)


@pytest.mark.parametrize("S,chunk", [(37, 16), (48, 16)])
def test_ssd_with_the_rule_matches_reference_gradient(monkeypatch, S, chunk):
    """The full SSD (the intra-chunk op through its rule, the inter-chunk
    recurrence in plain torch; a ragged S padded with dt = 0 steps) against
    jax.vjp of the reference's sequential oracle ``ssd_ref``, in every input."""
    monkeypatch.setattr(ssd, "ssd_intra_chunk", lambda *a: SSD.apply(*a))
    rng = np.random.default_rng(6)
    Bz, H, P, G, N = 2, 4, 8, 2, 4
    arrays = [_np(rng, Bz, S, H, P, scale=0.5), np.abs(_np(rng, Bz, S, H, scale=0.1)) + 0.01,
              -np.abs(_np(rng, H)) - 0.1, _np(rng, Bz, S, G, N, scale=0.5),
              _np(rng, Bz, S, G, N, scale=0.5), _np(rng, H), _np(rng, Bz, H, P, N, scale=0.3)]
    cots = [_np(rng, Bz, S, H, P), _np(rng, Bz, H, P, N)]
    rule = _grads(lambda x, dt, A, Bm, Cm, D, h0: ssd.ssd(x, dt, A, Bm, Cm, D=D, init_state=h0,
                                                          chunk=chunk), arrays, cots)
    _, vjp = jax.vjp(lambda x, dt, A, Bm, Cm, D, h0: jref.ssd_ref(x, dt, A, Bm, Cm, D=D,
                                                                  init_state=h0),
                     *map(jnp.asarray, arrays))
    _close(rule, vjp(tuple(map(jnp.asarray, cots))))


# ---------------------------------------------------------------- gradcheck (f64)

def _f64(*shape, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g, dtype=torch.float64) * scale).requires_grad_()


def test_gradcheck_rmsnorm():
    x, w, r = _f64(3, 8, seed=1), _f64(8, seed=2), _f64(3, 8, seed=3)
    assert torch.autograd.gradcheck(lambda a, b, c: RMS.apply(a, b, 1e-6, c), (x, w, r))
    assert torch.autograd.gradcheck(lambda a, b: RMS.apply(a, b, 1e-6, None), (x, w))


@pytest.mark.parametrize("window,chunk,q_offset", [(-1, 0, 0), (3, 0, 2), (-1, 4, 0)])
def test_gradcheck_attention(window, chunk, q_offset):
    q, k, v = _f64(1, 6, 4, 4, seed=4), _f64(1, 8, 2, 4, seed=5), _f64(1, 8, 2, 4, seed=6)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ATTN.apply(a, b, c, True, window, chunk, 0.5, q_offset), (q, k, v))


def test_gradcheck_grouped_matmul():
    assert torch.autograd.gradcheck(GMM.apply, (_f64(2, 3, 4, seed=7), _f64(2, 4, 5, seed=8)))


def test_gradcheck_ssd_intra_chunk():
    xs, b, c = _f64(2, 8, 3, seed=9), _f64(1, 8, 2, seed=10), _f64(1, 8, 2, seed=11)
    lda = (-_f64(2, 8, seed=12).abs() * 0.3).detach().requires_grad_()
    assert torch.autograd.gradcheck(lambda *a: SSD.apply(*a, 4), (xs, b, c, lda))


# ---------------------------------------------------------------- the ops themselves

def _meta(*shape):
    return torch.empty(*shape, device="meta", requires_grad=True)


OPS = {  # name -> (op, inputs, non-tensor args)
    "rmsnorm": (rms._rmsnorm_cuda, lambda: [_meta(2, 8, 64), _meta(64)], (1e-6, None)),
    "flash_attention": (fa._flash_attention_cuda,
                        lambda: [_meta(2, 16, 4, 16), _meta(2, 16, 2, 16), _meta(2, 16, 2, 16)],
                        (True, -1, 0, 0.25, 0)),
    "grouped_matmul": (gmm._grouped_matmul_cuda, lambda: [_meta(3, 5, 8), _meta(3, 8, 6)], ()),
    "ssd_intra_chunk": (ssd._ssd_intra_chunk_cuda,
                        lambda: [_meta(4, 32, 8), _meta(2, 32, 4), _meta(2, 32, 4), _meta(4, 32)],
                        (16,)),
}
FUNCTIONS = {"rmsnorm": rms._RMSNorm, "flash_attention": fa._FlashAttention,
             "grouped_matmul": gmm._GroupedMatmul, "ssd_intra_chunk": ssd._SSDIntraChunk}


def _shapes(ts):
    return [tuple(t.shape) for t in ts]


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_differentiable_under_autograd_grad(name):
    """The op's registered autograd formula (its fake kernel on meta)."""
    op, inputs, extra = OPS[name]
    xs = inputs()
    out = op(*xs, *extra)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad([o.sum() for o in outs], xs)
    assert _shapes(grads) == _shapes(xs)


@pytest.mark.parametrize("name", sorted(OPS))
def test_wrapper_function_under_func_vjp_and_grad(name):
    """``torch.func.vjp`` does not take an op's registered formula; the
    wrappers' autograd.Function (the same rule) does, and under
    ``torch.autograd.grad`` too."""
    _, inputs, extra = OPS[name]
    fn = FUNCTIONS[name]
    xs = inputs()
    out, vjp = torch.func.vjp(lambda *a: fn.apply(*a, *extra), *xs)
    cot = tuple(torch.ones_like(o) for o in out) if isinstance(out, tuple) else torch.ones_like(out)
    assert _shapes(vjp(cot)) == _shapes(xs)
    out = fn.apply(*xs, *extra)
    outs = out if isinstance(out, tuple) else (out,)
    assert _shapes(torch.autograd.grad([o.sum() for o in outs], xs)) == _shapes(xs)


def test_function_vmaps_through_the_op_rule():
    """Without gradients the Function's vmap rule runs the op under vmap,
    which the op's own vmap rule takes (the served decode's path)."""
    x, w = torch.empty(3, 2, 8, 64, device="meta"), torch.empty(64, device="meta")
    with torch.no_grad():
        y = torch.func.vmap(lambda a: rms._RMSNorm.apply(a, w, 1e-6, None))(x)
    assert y.shape == x.shape


def test_wrappers_take_the_plain_version_on_cpu_with_gradients():
    """On CPU tensors a wrapper is the plain version, and autograd of it."""
    rng = np.random.default_rng(7)
    arrays = [_np(rng, 2, 6, 16), _np(rng, 16)]
    gy = _np(rng, 2, 6, 16)
    _close(_grads(rms.rmsnorm, arrays, [gy]), _grads(ref.rmsnorm_ref, arrays, [gy]), tol=0)
