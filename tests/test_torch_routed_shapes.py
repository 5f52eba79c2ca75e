"""The shapes the Hopper kernels take beyond their first tiles, on the CPU.

f32 flash attention at head dims 64 and 128 (the 3xTF32 tensor-core
kernel on the card) and RMSNorm at widths that are whole 16-byte vectors
but not 16 of them (hymba's d 1600, 1000, 16: the register-resident
kernel with a lane's last vectors predicated). The port's plain versions,
which the kernels are held to on the card, are held here against the JAX
package's Pallas kernels in interpret mode on the same numpy inputs:
attention at atol = rtol = 2e-5, RMSNorm at 1e-5 in f32 and 2e-2 in
bf16. Also the attention kernel's numeric design, emulated: every product
through the 3xTF32 split, the softmax online over 64-key tiles in base 2,
within 2e-5 of an f64 computation, where single-pass TF32 is not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = 2e-5
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _both(arr: np.ndarray, dtype: str):
    """One numpy array as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(arr, JNP[dtype]),
            torch.from_numpy(arr.astype(np.float32)).to(TORCH[dtype]))


# (B, Sq, Sk, Hq, Hkv, masks): every mask the kernel keeps, GQA, MQA, and Sq
# and Sk off the kernel's 64-row and 64-key tiles
ATTENTION_CASES = [
    (2, 96, 96, 4, 2, {}),                               # causal GQA
    (1, 128, 128, 4, 4, {"window": 40}),                 # MHA, sliding window
    (1, 128, 128, 4, 2, {"chunk": 32}),                  # chunked-local
    (2, 1, 100, 4, 2, {"q_offset": 99}),                 # a decode step, Sk off the tile
    (2, 33, 77, 6, 3, {"q_offset": 44}),                 # GQA, both off the tile
    (2, 40, 100, 4, 1, {"causal": False}),               # MQA cross attention
    (1, 70, 130, 4, 2, {"window": 48, "q_offset": 60}),  # window and offset together
]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,kw", ATTENTION_CASES)
def test_f32_attention_matches_reference_kernel(B, Sq, Sk, Hq, Hkv, kw, D):
    assert fa.kernel_for(torch.float32, D) == fa.KERNELS[0]   # the card's kernel here
    rng = np.random.default_rng(D + Sq)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.standard_normal(s), "float32")
        for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    want = np.asarray(jax_flash_attention(qj, kj, vj, interpret=True, **kw), np.float32)
    for got in (ref.attention_ref(qt, kt, vt, **kw), ops.attention(qt, kt, vt, **kw),
                fa.flash_attention(qt, kt, vt, **kw)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(16, 1600), (3, 5, 1600), (9, 1000), (7, 16)])
def test_rmsnorm_off_the_tile_matches_reference_kernel(shape, residual, dtype):
    assert rms.kernel_for(TORCH[dtype], shape[-1]) == rms.KERNELS[0]
    rng = np.random.default_rng(shape[-1] + len(shape))
    xj, xt = _both(rng.standard_normal(shape), dtype)
    wj, wt = _both(rng.standard_normal(shape[-1]), "float32")
    rj, rt = _both(rng.standard_normal(shape), dtype) if residual else (None, None)
    want = np.asarray(jax_rmsnorm(xj, wj, residual=rj, interpret=True), np.float32)
    for got in (ref.rmsnorm_ref(xt, wt, residual=rt), ops.rmsnorm(xt, wt, residual=rt),
                rms.rmsnorm(xt, wt, residual=rt)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=RMS_TOL[dtype],
                                   rtol=RMS_TOL[dtype])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 to nearest, ties away from zero (``cvt.rna``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b through the split: lo·hi' + hi·lo' + hi·hi' in f32 (3 passes),
    or hi·hi' alone (single-pass TF32)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_attention(q, k, v, passes: int, tile: int = 64) -> torch.Tensor:
    """Causal attention of q, k, v (B, S, H, D; one kv head per query head)
    as the f32 tensor-core kernel forms it: S = Q Kᵀ and O += P V through
    ``_mm``, the softmax online over ``tile``-key tiles in base 2 with the
    scale folded in, masked scores -1e30, 1 / l at the end."""
    B, S, H, D = q.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, D)
    scale_log2 = D ** -0.5 * 1.4426950408889634
    pos = torch.arange(S)
    m = torch.full((B, H, S, 1), -torch.inf)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, D)
    for k0 in range(0, S, tile):
        ks = slice(k0, k0 + tile)
        s = _mm(qh, kh[:, :, ks].transpose(-1, -2), passes) * scale_log2
        s = torch.where(pos[:, None] >= pos[None, ks], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm(p, vh[:, :, ks], passes)
        m = m_new
    return (o / l).transpose(1, 2)


class TestAttention3xTF32:
    """At head dim 128 (the dense prefill's) and 64 (the taskgraph's)."""

    @staticmethod
    def _inputs(S, H, D):
        rng = np.random.default_rng(S + D)
        return [torch.from_numpy(rng.standard_normal((1, S, H, D)).astype(np.float32))
                for _ in range(3)]

    @pytest.mark.parametrize("S,H,D", [(512, 2, 128), (128, 4, 64)])
    def test_three_products_within_the_reference_tolerance(self, S, H, D):
        q, k, v = self._inputs(S, H, D)
        want = ref.attention_ref(q.double(), k.double(), v.double())
        got = _emulated_attention(q, k, v, passes=3)
        assert (got - want).abs().max().item() <= ATTN_TOL / 4

    def test_single_pass_tf32_is_not_enough(self):
        q, k, v = self._inputs(512, 2, 128)
        want = ref.attention_ref(q.double(), k.double(), v.double())
        got = _emulated_attention(q, k, v, passes=1)
        assert (got - want).abs().max().item() > 10 * ATTN_TOL
