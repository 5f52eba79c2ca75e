"""The port's kernel substrate against the JAX reference.

The port's plain versions (what CPU tensors take) are held against the JAX
Pallas kernels run in interpret mode, on the same numpy inputs, over the
cases of ``tests/test_kernels.py``: atol = rtol = 2e-5 in f32, 2e-2 in
bf16; grouped matmul at atol = ATOL·d, rtol = ATOL; SSD at 1e-3 (also
against the sequential ``ssd_ref``, with ragged S and state chaining).
Also: the registry's mode rules, the CUDA wrappers' fake and vmap rules
(on meta tensors) and input checks. The CUDA kernels themselves are held
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
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.moe_gmm import grouped_matmul as jax_grouped_matmul  # noqa: E402
from repro.kernels.ssd_scan import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra_chunk as jax_ssd_intra_chunk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops, ref, registry  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

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


class TestGroupedMatmulParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("E,C,d,f", [
        (4, 64, 128, 128), (2, 100, 256, 128), (8, 32, 128, 256),   # the reference's
        (3, 13, 99, 45),                                            # ragged C, d, f
    ])
    def test_matches_reference_kernel(self, E, C, d, f, dtype):
        rng = np.random.default_rng(11)
        xj, xt = _both(rng.standard_normal((E, C, d)) * 0.3, dtype)
        wj, wt = _both(rng.standard_normal((E, d, f)) * 0.3, dtype)
        want = np.asarray(jax_grouped_matmul(xj, wj, interpret=True), np.float32)
        for got in (ref.grouped_matmul_ref(xt, wt), ops.grouped_matmul(xt, wt),
                    gmm.grouped_matmul(xt, wt)):
            assert got.dtype == TORCH[dtype] and got.shape == (E, C, f)
            np.testing.assert_allclose(got.float().numpy(), want,
                                       atol=TOL[dtype] * d, rtol=TOL[dtype])


def _ssd_inputs(seed, Bz, S, H, P, G, N):
    """The reference test's distributions: dt > 0, A < 0, B and C at 0.5."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((Bz, S, H, P)),
            np.abs(rng.standard_normal((Bz, S, H))) * 0.1 + 0.01,
            -np.abs(rng.standard_normal(H)) - 0.1,
            rng.standard_normal((Bz, S, G, N)) * 0.5,
            rng.standard_normal((Bz, S, G, N)) * 0.5,
            rng.standard_normal(H),
            rng.standard_normal((Bz, H, P, N)) * 0.3)
    return [_both(a, "float32") for a in arrs]


def _ssd_close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-3, rtol=1e-3)


class TestSSDParity:
    @pytest.mark.parametrize("S,H,P,G,N,chunk", [
        (128, 2, 32, 1, 16, 32),
        (256, 4, 64, 2, 32, 64),
        (64, 2, 16, 1, 64, 64),    # single chunk
    ])
    def test_matches_reference_kernel(self, S, H, P, G, N, chunk):
        (xj, xt), (dtj, dtt), (Aj, At), (Bj, Bt), (Cj, Ct), (Dj, Dt), _ = \
            _ssd_inputs(0, 2, S, H, P, G, N)
        y_seq, h_seq = jax_ref.ssd_ref(xj, dtj, Aj, Bj, Cj, D=Dj)
        y_pal, h_pal = jax_ssd(xj, dtj, Aj, Bj, Cj, D=Dj, chunk=chunk, interpret=True)
        for fn in (ssd_scan.ssd, ops.ssd):
            y, h = fn(xt, dtt, At, Bt, Ct, D=Dt, chunk=chunk)
            for want_y, want_h in ((y_seq, h_seq), (y_pal, h_pal)):
                _ssd_close(y, want_y)
                _ssd_close(h, want_h)
        y, h = ref.ssd_ref(xt, dtt, At, Bt, Ct, D=Dt)
        _ssd_close(y, y_seq)
        _ssd_close(h, h_seq)

    @pytest.mark.parametrize("S,chunk", [(100, 32), (12, 16)])
    def test_ragged_sequence_with_init_state(self, S, chunk):
        """S padded with dt = 0 steps (the JAX kernel path asserts S % chunk
        == 0; its ref path pads the same way)."""
        (xj, xt), (dtj, dtt), (Aj, At), (Bj, Bt), (Cj, Ct), (Dj, Dt), (hj, ht) = \
            _ssd_inputs(1, 2, S, 4, 16, 2, 8)
        want_y, want_h = jax_ref.ssd_ref(xj, dtj, Aj, Bj, Cj, D=Dj, init_state=hj)
        for fn in (ssd_scan.ssd, ops.ssd):
            y, h = fn(xt, dtt, At, Bt, Ct, D=Dt, init_state=ht, chunk=chunk)
            assert y.shape == xt.shape and h.shape == ht.shape
            _ssd_close(y, want_y)
            _ssd_close(h, want_h)

    def test_state_chaining_matches_decode(self):
        """Chunked prefill state -> sequential decode == one long pass."""
        S, cut = 96, 64
        (xj, xt), (dtj, dtt), (Aj, At), (Bj, Bt), (Cj, Ct), _, _ = \
            _ssd_inputs(2, 1, S, 2, 16, 1, 8)
        y_all, _ = jax_ref.ssd_ref(xj, dtj, Aj, Bj, Cj)
        _, h = ssd_scan.ssd(xt[:, :cut], dtt[:, :cut], At, Bt[:, :cut], Ct[:, :cut],
                            chunk=32)
        ys = []
        for t in range(cut, S):
            y_t, h = ref.ssd_ref(xt[:, t:t + 1], dtt[:, t:t + 1], At, Bt[:, t:t + 1],
                                 Ct[:, t:t + 1], init_state=h)
            ys.append(y_t)
        _ssd_close(torch.cat(ys, dim=1), y_all[:, cut:])

    def test_intra_chunk_plain_version_matches_reference_kernel(self):
        """The custom op's plain version, in its own layouts (group rows read
        in place), against the Pallas intra-chunk kernel on repeated B, C."""
        rng = np.random.default_rng(3)
        BH, BG, S, P, N, chunk = 8, 2, 64, 16, 8, 32
        xs = rng.standard_normal((BH, S, P)).astype(np.float32)
        b = rng.standard_normal((BG, S, N)).astype(np.float32) * 0.5
        c = rng.standard_normal((BG, S, N)).astype(np.float32) * 0.5
        lda = -np.abs(rng.standard_normal((BH, S))).astype(np.float32) * 0.05
        rep = BH // BG
        want = jax_ssd_intra_chunk(jnp.asarray(xs), jnp.asarray(np.repeat(b, rep, 0)),
                                   jnp.asarray(np.repeat(c, rep, 0)),
                                   jnp.asarray(lda[..., None]), chunk=chunk,
                                   interpret=True)
        got = ssd_scan.ssd_intra_chunk(*(torch.from_numpy(a) for a in (xs, b, c, lda)),
                                       chunk)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _ssd_close(g, w)


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
            registry.dispatch("conv", torch.ones(2))
        assert registry.ops() == ["attention", "grouped_matmul", "rmsnorm", "ssd"]

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

    def test_grouped_matmul_fake_and_vmap_rules(self):
        x = torch.empty(3, 4, 8, 16, device="meta")
        w = torch.empty(4, 16, 24, device="meta")
        assert gmm._grouped_matmul_cuda(x[0], w).shape == (4, 8, 24)
        y = torch.func.vmap(lambda a: gmm._grouped_matmul_cuda(a, w))(x)   # folds into C
        assert y.shape == (3, 4, 8, 24)
        y = torch.func.vmap(lambda a: gmm._grouped_matmul_cuda(a, w), in_dims=2)(x)
        assert y.shape == (8, 3, 4, 24)
        ws = torch.empty(3, 4, 16, 24, device="meta")
        y = torch.func.vmap(gmm._grouped_matmul_cuda)(x, ws)              # per-member w
        assert y.shape == (3, 4, 8, 24)

    def test_ssd_intra_chunk_fake_and_vmap_rules(self):
        xs = torch.empty(6, 64, 16, device="meta")
        b = torch.empty(2, 64, 8, device="meta")
        lda = torch.empty(6, 64, device="meta")
        y, st, cd = ssd_scan._ssd_intra_chunk_cuda(xs, b, b, lda, 32)
        assert (y.shape, st.shape, cd.shape) == ((6, 64, 16), (6, 2, 8, 16), (6, 2, 1, 1))
        y, st, cd = torch.func.vmap(
            lambda a, l_: ssd_scan._ssd_intra_chunk_cuda(a, b, b, l_, 32))(
            xs.expand(3, *xs.shape), lda.expand(3, *lda.shape))
        assert (y.shape, st.shape, cd.shape) == ((3, 6, 64, 16), (3, 6, 2, 8, 16),
                                                 (3, 6, 2, 1, 1))

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
        x, w = torch.ones(2, 4, 8), torch.ones(2, 8, 3)
        with pytest.raises(ValueError, match="want x"):
            gmm._check(x, torch.ones(2, 7, 3))
        with pytest.raises(TypeError, match="float32/bfloat16"):
            gmm._check(x, w.bfloat16())
        with pytest.raises(ValueError, match="CUDA device"):
            gmm._check(x, w)
        xs, b, lda = torch.ones(4, 64, 16), torch.ones(2, 64, 8), torch.ones(4, 64)
        with pytest.raises(ValueError, match="chunk"):
            ssd_scan._check(xs, b, b, lda, 48)
        with pytest.raises(ValueError, match="head dim"):
            ssd_scan._check(torch.ones(4, 64, 160), b, b, lda, 32)
        with pytest.raises(ValueError, match="shared memory"):
            wide = torch.ones(2, 128, 256)
            ssd_scan._check(torch.ones(4, 128, 128), wide, wide, torch.ones(4, 128), 128)
        with pytest.raises(ValueError, match="BH % BG"):
            ssd_scan._check(xs, torch.ones(3, 64, 8), torch.ones(3, 64, 8), lda, 32)
        with pytest.raises(TypeError, match="float32"):
            ssd_scan._check(xs.bfloat16(), b, b, lda, 32)
        with pytest.raises(ValueError, match="CUDA device"):
            ssd_scan._check(xs, b, b, lda, 32)


SM90_FA, FIRST_FA = fa.KERNELS
SM90_GMM, FIRST_GMM = gmm.KERNELS


class TestKernelChoice:
    """Which kernel a CUDA call launches is a pure function of dtype and
    shape, decided before the launch (the kernels run only on the card)."""

    @pytest.mark.parametrize("dtype,head_dim,kernel", [
        (torch.bfloat16, 64, SM90_FA), (torch.bfloat16, 128, SM90_FA),
        (torch.bfloat16, 16, FIRST_FA), (torch.bfloat16, 32, FIRST_FA),
        (torch.float32, 16, FIRST_FA), (torch.float32, 32, FIRST_FA),
        (torch.float32, 64, SM90_FA), (torch.float32, 128, SM90_FA)])
    def test_attention(self, dtype, head_dim, kernel):
        assert fa.kernel_for(dtype, head_dim) == kernel

    @pytest.mark.parametrize("dtype,d,f,kernel", [
        (torch.bfloat16, 2048, 768, SM90_GMM), (torch.bfloat16, 768, 2048, SM90_GMM),
        (torch.bfloat16, 136, 200, SM90_GMM), (torch.bfloat16, 8, 8, SM90_GMM),
        (torch.bfloat16, 100, 64, FIRST_GMM), (torch.bfloat16, 128, 60, FIRST_GMM),
        (torch.bfloat16, 99, 45, FIRST_GMM), (torch.bfloat16, 0, 64, FIRST_GMM),
        (torch.float32, 2048, 768, FIRST_GMM), (torch.float32, 128, 128, FIRST_GMM)])
    def test_grouped_matmul(self, dtype, d, f, kernel):
        assert gmm.kernel_for(dtype, d, f) == kernel

    @pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b"])
    def test_model_shapes_take_the_new_kernels(self, arch):
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        assert fa.kernel_for(cfg.compute_dtype, cfg.head_dim) == SM90_FA
        if cfg.family == "moe":   # up / gate (d -> f) and down (f -> d)
            for d, f in ((cfg.d_model, cfg.expert_d_ff), (cfg.expert_d_ff, cfg.d_model)):
                assert gmm.kernel_for(cfg.compute_dtype, d, f) == SM90_GMM

    def test_counters_reset_together(self):
        fa.launches_by_kernel[SM90_FA] += 2
        gmm.launches_by_kernel[FIRST_GMM] += 1
        fa.reset_launches()
        gmm.reset_launches()
        assert fa.launches == gmm.launches == 0
        assert set(fa.launches_by_kernel) == set(fa.KERNELS)
        assert not any(fa.launches_by_kernel.values()) and not any(gmm.launches_by_kernel.values())


SM90_RMS, FIRST_RMS = rms.KERNELS
SM90_SSD, FIRST_SSD = ssd_scan.KERNELS


class TestNormAndSSDKernelChoice:
    """The RMSNorm and SSD wrappers pick the register-resident and the
    tensor-core kernel by dtype, shape and 16-byte alignment, for every
    served shape: RMSNorm at any d that is whole 16-byte vectors up to
    MAX_D; odd d, wider d and unaligned tensors take the first design."""

    @pytest.mark.parametrize("dtype,d,kernel", [
        (torch.bfloat16, 128, SM90_RMS), (torch.bfloat16, 1024, SM90_RMS),
        (torch.bfloat16, 2048, SM90_RMS), (torch.bfloat16, 384, SM90_RMS),
        (torch.bfloat16, 8192, SM90_RMS), (torch.float32, 64, SM90_RMS),
        (torch.float32, 128, SM90_RMS), (torch.float32, 2048, SM90_RMS),
        (torch.float32, 8192, SM90_RMS),
        (torch.float32, 1000, SM90_RMS), (torch.float32, 16, SM90_RMS),
        (torch.bfloat16, 1000, SM90_RMS), (torch.bfloat16, 64, SM90_RMS),
        (torch.bfloat16, 192, SM90_RMS), (torch.bfloat16, 16384, FIRST_RMS),
        (torch.bfloat16, 1600, SM90_RMS), (torch.float32, 1600, SM90_RMS),   # hymba
        (torch.float32, 4, SM90_RMS), (torch.bfloat16, 8, SM90_RMS),       # one vector
        (torch.bfloat16, 1001, FIRST_RMS), (torch.float32, 1001, FIRST_RMS),
        (torch.bfloat16, 4, FIRST_RMS), (torch.float32, 16384, FIRST_RMS),
        (torch.float32, 8196, FIRST_RMS)])
    def test_rmsnorm(self, dtype, d, kernel):
        assert rms.kernel_for(dtype, d) == kernel

    @pytest.mark.parametrize("P,N,chunk,kernel", [
        (64, 128, 128, SM90_SSD),                                    # mamba2-370m
        (32, 16, 32, SM90_SSD), (64, 32, 64, SM90_SSD), (16, 64, 64, SM90_SSD),   # the reference's
        (16, 8, 32, SM90_SSD), (16, 8, 12, SM90_SSD), (32, 96, 64, SM90_SSD),
        (128, 32, 64, FIRST_SSD), (30, 16, 32, FIRST_SSD), (16, 10, 32, FIRST_SSD),
        (64, 256, 128, FIRST_SSD), (64, 128, 256, FIRST_SSD)])
    def test_ssd(self, P, N, chunk, kernel):
        assert ssd_scan.kernel_for(P, N, chunk) == kernel

    @pytest.mark.parametrize("choose", [
        lambda aligned: rms.kernel_for(torch.bfloat16, 2048, aligned) == FIRST_RMS,
        lambda aligned: rms.kernel_for(torch.float32, 128, aligned) == FIRST_RMS,
        lambda aligned: ssd_scan.kernel_for(64, 128, 128, aligned) == FIRST_SSD],
        ids=["rmsnorm-bf16", "rmsnorm-f32", "ssd"])
    def test_misaligned_inputs_take_the_first_design(self, choose):
        """The new kernels need 16-byte aligned tensors; an offset view goes
        to the first design before any launch, never after a failure."""
        assert choose(aligned=False)

    @pytest.mark.parametrize("mod", [rms, ssd_scan])
    @pytest.mark.parametrize("offset,aligned", [(0, True), (1, False), (2, False), (4, True)])
    def test_alignment_of_an_offset_view(self, mod, offset, aligned):
        buf = torch.zeros(64)   # f32: 4 elements a 16-byte step
        assert mod._aligned(buf[offset:], buf) == aligned

    @pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m"])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_model_shapes_take_the_new_kernels(self, arch, dtype):
        """In the served dtype (bf16) and in the f32 of the logits checks."""
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        widths = [cfg.d_model]
        if cfg.qk_norm:
            widths.append(cfg.head_dim)
        if cfg.family == "ssm":   # the gated norm on d_inner; SSD's (chunk, P, N)
            widths.append(cfg.ssm_inner)
            assert ssd_scan.kernel_for(cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk) == SM90_SSD
        for d in widths:
            assert rms.kernel_for(dtype, d) == SM90_RMS

    @pytest.mark.parametrize("chunk", [1, 12, 32, 64, 100, 128])
    def test_ssd_shared_memory_fits_where_chosen(self, chunk):
        """The tensor-core kernel's shared memory (the launcher's own sum)
        fits the H100's 232,448 bytes at every shape sent to it."""
        chosen = 0
        for P in range(4, 129, 4):
            for N in range(4, 257, 4):
                if ssd_scan.kernel_for(P, N, chunk) == SM90_SSD:
                    assert ssd_scan.smem_bytes(chunk, P, N, SM90_SSD) <= 232_448
                    chosen += 1
        assert chosen > 0
        assert ssd_scan.smem_bytes(128, 64, 128, SM90_SSD) == 232_448   # the path's: all of it

    def test_reset_launches_zeroes_the_new_counters(self):
        rms.launches_by_kernel[SM90_RMS] += 3
        ssd_scan.launches_by_kernel[SM90_SSD] += 2
        ssd_scan.launches_by_kernel[FIRST_SSD] += 1
        rms.reset_launches()
        ssd_scan.reset_launches()
        assert rms.launches == ssd_scan.launches == 0
        assert set(rms.launches_by_kernel) == set(rms.KERNELS)
        assert set(ssd_scan.launches_by_kernel) == set(ssd_scan.KERNELS)
        assert not any(rms.launches_by_kernel.values())
        assert not any(ssd_scan.launches_by_kernel.values())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the tensor-core SSD kernel forms it: each operand split into
    hi = tf32(a) and lo = tf32(a - hi), lo·hi' + hi·lo' + hi·hi' summed in
    f32 (products of TF32 values are exact in f32). ``passes=1`` is
    single-pass TF32 (hi·hi' alone)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


class TestSSD3xTF32:
    """The numeric design of the tensor-core SSD kernel, emulated on the
    CPU at the mamba2-370m prefill shape (4 x 32 heads, 1 group, S 512,
    chunk 128, P 64, N 128): the three products of
    ``ssd_intra_chunk_ref`` through the 3xTF32 split come within 1e-5
    relative L2 of an f64 computation; single-pass TF32 does not."""

    @staticmethod
    def _products(passes: int):
        """(y, state) through the split with ``passes``, and in f64."""
        rng = np.random.default_rng(21)
        Bz, H, G, S, P, N, Q = 4, 32, 1, 512, 64, 128, 128
        x = rng.standard_normal((Bz * H, S, P))
        dt = np.abs(rng.standard_normal((Bz * H, S))) * 0.1 + 0.01
        A = -np.abs(rng.standard_normal(H)) - 0.1
        xs = torch.from_numpy((x * dt[..., None]).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal((Bz * G, S, N)) * 0.5).astype(np.float32))
        c = torch.from_numpy((rng.standard_normal((Bz * G, S, N)) * 0.5).astype(np.float32))
        lda = torch.from_numpy((dt * np.tile(A, Bz)[:, None]).astype(np.float32))
        BH, BG, nc, rep = Bz * H, Bz * G, S // Q, H // G
        lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool))

        def run(mm, dtype):
            # the kernel's steps: C·Bᵀ once per group, then per head the
            # decay applied to it (selected on and below the diagonal), y
            # and the end-state
            cums = torch.cumsum(lda.to(dtype).reshape(BH, nc, Q), dim=2)
            b_c, c_c = (t.to(dtype).reshape(BG, nc, Q, N) for t in (b, c))
            cb = mm(c_c, b_c.transpose(-1, -2)).repeat_interleave(rep, dim=0)
            scores = torch.where(
                lower, cb * torch.exp(cums[..., :, None] - cums[..., None, :]), 0.0)
            xs_c = xs.to(dtype).reshape(BH, nc, Q, P)
            y = mm(scores, xs_c).reshape(BH, S, P)
            dte = torch.exp(cums[..., -1:] - cums)
            bd = b_c.repeat_interleave(rep, dim=0) * dte[..., None]
            return y, mm(bd.transpose(-1, -2), xs_c)

        got = run(lambda a, b_: _mm_3xtf32(a, b_, passes), torch.float32)
        want = run(torch.matmul, torch.float64)
        # the f64 steps are those of the plain version
        for w, r in zip(want, ssd_scan.ssd_intra_chunk(xs, b, c, lda, Q)):
            assert TestSSD3xTF32._rel_l2(r, w) <= 1e-6
        return got, want

    @staticmethod
    def _rel_l2(got, want):
        return ((got.double() - want).norm() / want.norm()).item()

    def test_tf32_rounding_is_round_to_nearest(self):
        one = torch.tensor([1.0, -1.0])
        ulp = 2.0 ** -10
        for frac, up in ((0.49, False), (0.5, True), (0.51, True)):   # ties away from zero
            got = _tf32(one * (1 + frac * ulp))
            torch.testing.assert_close(got, one * (1 + ulp if up else 1.0), atol=0, rtol=0)
        assert (_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()

    def test_three_products_within_1e5_of_f64(self):
        (y, state), (want_y, want_state) = self._products(passes=3)
        assert self._rel_l2(y, want_y) <= 1e-5
        assert self._rel_l2(state, want_state) <= 1e-5

    def test_single_pass_tf32_is_not_enough(self):
        (y, state), (want_y, want_state) = self._products(passes=1)
        assert self._rel_l2(y, want_y) > 1e-4
        assert self._rel_l2(state, want_state) > 1e-4
