"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed. On the card, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared ``tests/conftest.py`` imports the JAX package.)
Each kernel is held against its plain version (atol = rtol = 2e-5 in f32,
2e-2 in bf16), under ``torch.func.vmap`` too, and the reduced model is run
with the kernels and with the plain versions.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref, registry  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _randn(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [{}, {"window": 64}, {"chunk": 64},
                                {"q_offset": 37}, {"causal": False}])
def test_flash_attention(dtype, kw):
    g = torch.Generator("cuda").manual_seed(0)
    q = _randn(g, 2, 100, 8, 64, dtype=dtype)
    k, v = _randn(g, 2, 150, 2, 64, dtype=dtype), _randn(g, 2, 150, 2, 64, dtype=dtype)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == before + 1
    torch.testing.assert_close(got.float(), ref.attention_ref(q, k, v, **kw).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm(dtype, residual):
    g = torch.Generator("cuda").manual_seed(0)
    x = _randn(g, 3, 33, 2048, dtype=dtype)
    w = _randn(g, 2048)
    r = _randn(g, 3, 33, 2048, dtype=dtype) if residual else None
    before = rms.launches
    got = rms.rmsnorm(x, w, residual=r)
    assert rms.launches == before + 1
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w, residual=r).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_vmap_rules_launch_once_and_agree():
    g = torch.Generator("cuda").manual_seed(1)
    x, w = _randn(g, 4, 5, 128), _randn(g, 128)
    before = rms.launches
    got = torch.func.vmap(lambda a: rms.rmsnorm(a, w), in_dims=1)(x)
    assert rms.launches == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, w).transpose(0, 1),
                               atol=2e-5, rtol=2e-5)
    q, k = _randn(g, 3, 2, 40, 4, 32), _randn(g, 2, 40, 2, 32)
    before = fa.launches
    got = torch.func.vmap(lambda a: fa.flash_attention(a, k, k))(q)
    assert fa.launches == before + 1
    want = torch.stack([ref.attention_ref(q[i], k, k) for i in range(3)])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(4, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        rms.rmsnorm(x.t(), torch.ones(4, device="cuda"))


def test_reduced_model_kernels_match_plain_versions():
    cfg = reduced(get_config("qwen2.5-3b"))
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    tokens = torch.randint(2, cfg.vocab_size, (2, 40), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    with torch.no_grad():
        got = M.greedy_decode(params, cfg, {"tokens": tokens}, 5, 48)
        with registry.kernel_mode_scope("ref"):
            want = M.greedy_decode(params, cfg, {"tokens": tokens}, 5, 48)
        logits, _, _ = M.prefill(params, cfg, {"tokens": tokens}, 48)
        with registry.kernel_mode_scope("ref"):
            logits_ref, _, _ = M.prefill(params, cfg, {"tokens": tokens}, 48)
    torch.testing.assert_close(logits, logits_ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, want)
