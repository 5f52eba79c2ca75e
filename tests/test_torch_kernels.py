"""The port's kernel substrate against the JAX reference.

The port's plain versions (what CPU tensors take) are held against the JAX
Pallas kernels run in interpret mode, on the same numpy inputs, over the
cases of ``tests/test_kernels.py``: atol = rtol = 2e-5 in f32, 2e-2 in
bf16. Also: the registry's mode rules, the CUDA wrappers' vmap rules (on
meta tensors) and input checks. The CUDA kernels themselves are held
against their plain versions on the card, in ``test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref, registry  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(arr: np.ndarray, dtype: str):
    """One numpy array as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(arr, JNP[dtype]),
            torch.from_numpy(arr.astype(np.float32)).to(TORCH[dtype]))


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _qkv(seed, B, Sq, Sk, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal(s), dtype)
            for s in ((B, Sq, hq, d), (B, Sk, hkv, d), (B, Sk, hkv, d))]


class TestAttentionParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("seq,hq,hkv,d", [
        (64, 4, 4, 64),        # MHA
        (64, 8, 2, 64),        # GQA
        (64, 4, 1, 128),       # MQA
        (50, 4, 2, 64),        # ragged tail
    ])
    def test_causal(self, seq, hq, hkv, d, dtype):
        (qj, qt), (kj, kt), (vj, vt) = _qkv(0, 2, seq, seq, hq, hkv, d, dtype)
        want = jax_flash_attention(qj, kj, vj, causal=True, interpret=True)
        _close(ref.attention_ref(qt, kt, vt, causal=True), want, dtype)
        _close(ops.attention(qt, kt, vt, causal=True), want, dtype)

    @pytest.mark.parametrize("kw", [{"window": 16}, {"window": 32}, {"window": 50},
                                    {"chunk": 32}, {"chunk": 64}])
    def test_local_masks(self, kw):
        (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 1, 128, 128, 4, 2, 32, "float32")
        want = jax_flash_attention(qj, kj, vj, causal=True, interpret=True, **kw)
        _close(ops.attention(qt, kt, vt, causal=True, **kw), want, "float32")

    def test_cross_attention(self):
        (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 2, 64, 200, 4, 2, 64, "float32")
        want = jax_flash_attention(qj, kj, vj, causal=False, interpret=True)
        _close(ops.attention(qt, kt, vt, causal=False), want, "float32")

    def test_decode_offset(self):
        (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 2, 1, 128, 4, 2, 64, "float32")
        want = jax_flash_attention(qj, kj, vj, causal=True, q_offset=127, interpret=True)
        _close(ops.attention(qt, kt, vt, causal=True, q_offset=127), want, "float32")

    def test_cuda_wrapper_takes_plain_version_on_cpu(self):
        (_, qt), (_, kt), (_, vt) = _qkv(4, 1, 24, 24, 4, 2, 16, "float32")
        torch.testing.assert_close(fa.flash_attention(qt, kt, vt),
                                   ref.attention_ref(qt, kt, vt), atol=0, rtol=0)


class TestRMSNormParity:
    @pytest.mark.parametrize("shape", [(4, 17, 64), (1, 8, 512), (128, 256)])
    @pytest.mark.parametrize("residual", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_reference_kernel(self, shape, residual, dtype):
        rng = np.random.default_rng(5)
        xj, xt = _both(rng.standard_normal(shape), dtype)
        wj, wt = _both(rng.standard_normal(shape[-1]), "float32")
        rj, rt = _both(rng.standard_normal(shape), dtype) if residual else (None, None)
        want = jax_rmsnorm(xj, wj, residual=rj, interpret=True)
        _close(ref.rmsnorm_ref(xt, wt, residual=rt), want, dtype)
        _close(ops.rmsnorm(xt, wt, residual=rt), want, dtype)
        _close(rms.rmsnorm(xt, wt, residual=rt), want, dtype)


class TestRegistry:
    def test_auto_resolves_by_device(self):
        assert registry.resolved_mode("auto", torch.device("cpu")) == "ref"
        assert registry.resolved_mode("auto", torch.device("cuda")) == "cuda"
        assert registry.resolved_mode("ref", torch.device("cuda")) == "ref"
        assert registry.resolved_mode("auto") == "auto"
        assert registry.resolve("rmsnorm", torch.device("cpu"), "auto") is ref.rmsnorm_ref

    def test_cuda_mode_on_cpu_tensors_raises(self):
        x = torch.ones(2, 8)
        with registry.kernel_mode_scope("cuda"), pytest.raises(ValueError, match="CUDA"):
            ops.rmsnorm(x, torch.ones(8))
        with pytest.raises(ValueError, match="CUDA"):
            registry.dispatch("attention", torch.ones(1, 4, 2, 16), torch.ones(1, 4, 2, 16),
                              torch.ones(1, 4, 2, 16), mode="cuda")

    def test_unknown_mode_and_op(self):
        with pytest.raises(ValueError, match="expected one of"):
            registry.set_kernel_mode("pallas")
        with pytest.raises(KeyError, match="registered ops"):
            registry.dispatch("ssd", torch.ones(2))
        assert registry.ops() == ["attention", "rmsnorm"]

    def test_scope_is_thread_local_and_restores(self):
        seen = {}
        with registry.kernel_mode_scope("ref"):
            t = threading.Thread(target=lambda: seen.update(mode=registry.kernel_mode()))
            t.start()
            t.join(timeout=10)
            assert registry.kernel_mode() == "ref"
        assert not t.is_alive()
        assert seen["mode"] == "auto"
        assert registry.kernel_mode() == "auto"

    def test_bogus_env_var_fails_at_import(self):
        env = {**os.environ, "REPRO_TORCH_KERNELS": "bogus",
               "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
        proc = subprocess.run([sys.executable, "-c", "import repro_torch.kernels.registry"],
                              env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "REPRO_TORCH_KERNELS" in proc.stderr
        assert "('auto', 'cuda', 'ref')" in proc.stderr


class TestCudaWrappers:
    """Shape logic of the custom ops' vmap rules, on meta tensors (the
    CUDA implementation runs only on the card)."""

    def test_rmsnorm_vmap_folds_into_rows(self):
        x = torch.empty(3, 5, 16, device="meta")
        w = torch.empty(16, device="meta")
        r = torch.empty(3, 16, device="meta")
        y = torch.func.vmap(lambda a: rms._rmsnorm_cuda(a, w, 1e-6, r), in_dims=1)(x)
        assert y.shape == (5, 3, 16)
        ws = torch.empty(5, 16, device="meta")
        y = torch.func.vmap(lambda a, b: rms._rmsnorm_cuda(a, b, 1e-6, None))(
            torch.empty(5, 2, 16, device="meta"), ws)
        assert y.shape == (5, 2, 16)

    def test_attention_vmap_folds_into_batch(self):
        q = torch.empty(3, 2, 7, 4, 16, device="meta")
        k = torch.empty(2, 9, 2, 16, device="meta")
        o = torch.func.vmap(
            lambda a: fa._flash_attention_cuda(a, k, k, True, -1, 0, 0.25, 0))(q)
        assert o.shape == (3, 2, 7, 4, 16)

    def test_checks_reject_what_the_kernel_does_not_take(self):
        q = torch.ones(1, 4, 2, 48)
        with pytest.raises(ValueError, match="head_dim"):
            fa._check(q, q, q, -1, 0, 0)
        q16 = torch.ones(1, 4, 2, 64, dtype=torch.float16)
        with pytest.raises(TypeError, match="float32/bfloat16"):
            fa._check(q16, q16, q16, -1, 0, 0)
        q = torch.ones(1, 4, 2, 64)
        with pytest.raises(ValueError, match="CUDA device"):
            fa._check(q, q, q, -1, 0, 0)
        with pytest.raises(ValueError, match="d <= 8192"):
            rms._check(torch.ones(2, 9000), torch.ones(9000), None)
        with pytest.raises(ValueError, match="weight shape"):
            rms._check(torch.ones(2, 8), torch.ones(4), None)
        with pytest.raises(ValueError, match="CUDA device"):
            rms._check(torch.ones(2, 8), torch.ones(8), None)
