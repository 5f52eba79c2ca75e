"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed. On the card, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared ``tests/conftest.py`` imports the JAX package.)
Each kernel is held against its plain version (atol = rtol = 2e-5 in f32,
2e-2 in bf16; grouped matmul at atol = TOL·d, rtol = TOL; SSD at 1e-3),
under ``torch.func.vmap`` too, and the reduced models of all ten configs
are run with the kernels and with the plain versions; the MoE layer at
full width gives the same bits on every run. The kernels are also held at
the shapes the other seven models give them (whisper's non-causal and
cross-attention over 1500 frames, hymba's windowed GQA 5, the
register-resident RMSNorm at d 1600, llama4's grouped matmul, hymba's SSD),
with one
full-width hymba block and one whisper decoder block in bf16 (relative L2
2e-2), and a captured whisper decode step bitwise equal to an uncaptured
one. Each
attention, grouped-matmul, RMSNorm and SSD case of the redesigned kernels
also checks that the kernel ``kernel_for`` picks (TMA + wgmma in bf16
and, as 3xTF32 products, in f32; rows in registers; 3xTF32 tensor cores
at the shapes they take; the first design otherwise) is the one whose
count rose. Regions replayed from a captured
CUDA graph (``lower_tdg(jit=True)``) must equal the uncaptured replay and
eager, capture once per buffer signature, raise when a payload syncs the
host, return outputs the next replay leaves alone, and launch the RMSNorm
and flash-attention kernels inside the graph. A donated slot round-trips
through the graph with nothing copied in; graphs are bounded and released;
the server's steps are captured from its scheduler thread while client
threads keep issuing device ops, give what the uncaptured steps give, and a
failed capture fails a batch without counting as a fallback.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ref, registry  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
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


def _one_launch_of(mod, kernel, run):
    """Run ``run()``; exactly one launch, of ``kernel``, must be counted."""
    before, by_kernel = mod.launches, dict(mod.launches_by_kernel)
    out = run()
    assert mod.launches == before + 1
    assert {k: n - by_kernel[k] for k, n in mod.launches_by_kernel.items()
            if n != by_kernel[k]} == {kernel: 1}
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,kw", [
    *((2, 100, 150, 8, 2, 64, kw) for kw in ({}, {"window": 64}, {"chunk": 64},
                                             {"q_offset": 37}, {"causal": False})),
    # edges of the TMA + wgmma kernel (bf16): decode-shaped, a window, Sk off
    # its 128-key tile at both head dims
    (2, 1, 128, 4, 2, 128, {"q_offset": 127}), (1, 256, 256, 4, 2, 128, {"window": 100}),
    (2, 200, 200, 4, 2, 64, {}), (2, 200, 200, 4, 2, 128, {}),
    # f32 takes the same kernel as 3xTF32 products: the dense prefill shape,
    # the taskgraph's fused wave, GQA off its 64-key tile under a chunk and an
    # offset, a window with an offset; head dims 16 and 32 the first design
    (4, 512, 512, 16, 2, 128, {}), (16, 128, 128, 4, 4, 64, {}),
    (2, 33, 77, 6, 3, 128, {"chunk": 16, "q_offset": 5}),
    (1, 96, 160, 8, 2, 64, {"window": 48, "q_offset": 64}),
    (2, 100, 100, 4, 2, 32, {}), (2, 24, 24, 4, 2, 16, {})])
def test_flash_attention(dtype, B, Sq, Sk, Hq, Hkv, D, kw):
    g = torch.Generator("cuda").manual_seed(0)
    q = _randn(g, B, Sq, Hq, D, dtype=dtype)
    k, v = _randn(g, B, Sk, Hkv, D, dtype=dtype), _randn(g, B, Sk, Hkv, D, dtype=dtype)
    got = _one_launch_of(fa, fa.kernel_for(dtype, D), lambda: fa.flash_attention(q, k, v, **kw))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f", [
    (4, 64, 128, 128), (3, 37, 100, 60), (8, 8, 2048, 768),
    # edges of the TMA + wgmma kernel (bf16): C of 1, 65 and 200 rows; d and f
    # multiples of 8 off its 64 x 128 tiles
    (2, 1, 256, 128), (2, 65, 256, 128), (2, 200, 256, 128), (3, 40, 136, 200)])
def test_grouped_matmul(dtype, E, C, d, f):
    g = torch.Generator("cuda").manual_seed(0)
    x, w = _randn(g, E, C, d, dtype=dtype) * 0.3, _randn(g, E, d, f, dtype=dtype) * 0.3
    got = _one_launch_of(gmm, gmm.kernel_for(dtype, d, f), lambda: gmm.grouped_matmul(x, w))
    torch.testing.assert_close(got.float(), ref.grouped_matmul_ref(x, w).float(),
                               atol=TOL[dtype] * d, rtol=TOL[dtype])


@pytest.mark.parametrize("S,H,P,G,N,chunk", [(128, 4, 32, 2, 16, 32), (100, 4, 64, 1, 128, 128),
                                             (12, 2, 16, 1, 8, 16)])
def test_ssd(S, H, P, G, N, chunk):
    g = torch.Generator("cuda").manual_seed(0)
    x = _randn(g, 2, S, H, P)
    dt = _randn(g, 2, S, H).abs() * 0.1 + 0.01
    A = -_randn(g, H).abs() - 0.1
    Bm, Cm = _randn(g, 2, S, G, N) * 0.5, _randn(g, 2, S, G, N) * 0.5
    h0, D = _randn(g, 2, H, P, N) * 0.3, _randn(g, H)
    before = ssd_scan.launches
    y, h = ssd_scan.ssd(x, dt, A, Bm, Cm, D=D, init_state=h0, chunk=chunk)
    assert ssd_scan.launches == before + 1
    for want_y, want_h in (ref.ssd_ref(x, dt, A, Bm, Cm, D=D, init_state=h0),
                           ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D=D, init_state=h0,
                                               chunk=min(chunk, S))):
        torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(h, want_h, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("shape,xdt,wdt,residual", [
    ((2, 17, 16, 128), torch.bfloat16, torch.float32, False),   # qk-norm: 16 lanes a row
    ((3, 7, 4, 128), torch.bfloat16, torch.bfloat16, True),
    ((65, 1024), torch.bfloat16, torch.float32, False),
    ((65, 1024), torch.float32, torch.bfloat16, True),
    ((3, 33, 2048), torch.bfloat16, torch.float32, True),
    ((33, 2048), torch.float32, torch.float32, False),
    ((9, 384), torch.bfloat16, torch.float32, False),            # a partly filled lane
    ((16, 4096), torch.bfloat16, torch.bfloat16, False),         # 2 warps a row
    ((6, 8192), torch.float32, torch.float32, True),             # 8 warps a row
    ((8, 8192), torch.bfloat16, torch.float32, True),
    ((11, 64), torch.float32, torch.float32, False),
    ((33, 1000), torch.float32, torch.float32, False),           # whole vectors, not 16
    ((5, 16), torch.float32, torch.float32, True),
    ((2048, 1600), torch.bfloat16, torch.float32, False),        # hymba: 7 or 6 vectors a lane
    ((16, 1600), torch.bfloat16, torch.float32, True),
    ((64, 1600), torch.float32, torch.float32, True),            # 2 warps, 400 vectors
    ((33, 1000), torch.bfloat16, torch.bfloat16, True),
    ((5, 16), torch.bfloat16, torch.float32, False),
    ((7, 1001), torch.float32, torch.float32, False),            # odd d: the first design
    ((7, 1001), torch.bfloat16, torch.float32, True)])
def test_rmsnorm_kernel_choice(shape, xdt, wdt, residual):
    g = torch.Generator("cuda").manual_seed(0)
    x, w = _randn(g, *shape, dtype=xdt), _randn(g, shape[-1], dtype=wdt)
    r = _randn(g, *shape, dtype=xdt) if residual else None
    got = _one_launch_of(rms, rms.kernel_for(xdt, shape[-1]),
                         lambda: rms.rmsnorm(x, w, residual=r))
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w, residual=r).float(),
                               atol=TOL[xdt], rtol=TOL[xdt])


@pytest.mark.parametrize("Bz,S,H,P,G,N,chunk", [
    (2, 128, 2, 32, 1, 16, 32), (2, 256, 4, 64, 2, 32, 64), (2, 64, 2, 16, 1, 64, 64),
    (2, 512, 8, 64, 1, 128, 128),      # mamba2-370m's (chunk, P, N), 8 heads a group
    (2, 100, 4, 16, 1, 16, 32),        # ragged S
    (1, 12, 4, 16, 2, 8, 16),          # chunk 12, zero-filled to the tiles
    (2, 256, 8, 64, 1, 64, 64),        # more heads a group than a block takes
    (1, 128, 2, 128, 1, 32, 64)])      # head dim 128: the first design
def test_ssd_kernel_choice(Bz, S, H, P, G, N, chunk):
    g = torch.Generator("cuda").manual_seed(0)
    x = _randn(g, Bz, S, H, P)
    dt = _randn(g, Bz, S, H).abs() * 0.1 + 0.01
    A = -_randn(g, H).abs() - 0.1
    Bm, Cm = _randn(g, Bz, S, G, N) * 0.5, _randn(g, Bz, S, G, N) * 0.5
    h0, D = _randn(g, Bz, H, P, N) * 0.3, _randn(g, H)
    y, h = _one_launch_of(ssd_scan, ssd_scan.kernel_for(P, N, min(chunk, S)),
                          lambda: ssd_scan.ssd(x, dt, A, Bm, Cm, D=D, init_state=h0, chunk=chunk))
    want_y, want_h = ref.ssd_ref(x, dt, A, Bm, Cm, D=D, init_state=h0)
    torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(h, want_h, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("res", [False, True])
def test_rmsnorm_misaligned_view_takes_the_first_design(xdt, res):
    """A contiguous view at an odd storage offset is normalised by the first
    design (the register-resident kernel needs 16-byte aligned tensors)."""
    g = torch.Generator("cuda").manual_seed(2)
    n, d = 9, 2048
    x = _randn(g, n * d + 1, dtype=xdt)[1:].view(n, d)
    r = _randn(g, n * d + 1, dtype=xdt)[1:].view(n, d) if res else None
    w = _randn(g, d)
    got = _one_launch_of(rms, rms.KERNELS[1], lambda: rms.rmsnorm(x, w, residual=r))
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w, residual=r).float(),
                               atol=TOL[xdt], rtol=TOL[xdt])


def test_ssd_misaligned_view_takes_the_first_design():
    g = torch.Generator("cuda").manual_seed(2)
    xs = _randn(g, 8 * 256 * 64 + 1)[1:].view(8, 256, 64)
    b, c = _randn(g, 2, 256, 128) * 0.5, _randn(g, 2, 256, 128) * 0.5
    lda = -_randn(g, 8, 256).abs() * 0.05
    got = _one_launch_of(ssd_scan, ssd_scan.KERNELS[1],
                         lambda: ssd_scan.ssd_intra_chunk(xs, b, c, lda, 128))
    for o, want in zip(got, ref.ssd_intra_chunk_ref(xs, b, c, lda, 128)):
        torch.testing.assert_close(o, want, atol=1e-4, rtol=1e-4)


def test_new_kernels_vmap_rules_launch_once():
    g = torch.Generator("cuda").manual_seed(3)
    x, w = _randn(g, 4, 5, 128, dtype=torch.bfloat16), _randn(g, 128)
    got = _one_launch_of(rms, rms.KERNELS[0],
                         lambda: torch.func.vmap(lambda a: rms.rmsnorm(a, w), in_dims=1)(x))
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).transpose(0, 1).float(),
                               atol=2e-2, rtol=2e-2)
    xs, b, lda = _randn(g, 3, 4, 64, 16), _randn(g, 2, 64, 8), -_randn(g, 3, 4, 64).abs()
    got = _one_launch_of(ssd_scan, ssd_scan.KERNELS[0], lambda: torch.func.vmap(
        lambda a, l_: ssd_scan.ssd_intra_chunk(a, b, b, l_, 32))(xs, lda))
    for i in range(3):
        for o, want in zip(got, ref.ssd_intra_chunk_ref(xs[i], b, b, lda[i], 32)):
            torch.testing.assert_close(o[i], want, atol=1e-4, rtol=1e-4)


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
    x, w = _randn(g, 3, 4, 8, 64), _randn(g, 4, 64, 32)          # shared w: folds into C
    before = gmm.launches
    got = torch.func.vmap(lambda a: gmm.grouped_matmul(a, w))(x)
    assert gmm.launches == before + 1
    torch.testing.assert_close(got, torch.stack([ref.grouped_matmul_ref(x[i], w)
                                                 for i in range(3)]), atol=1e-4, rtol=2e-5)
    ws = _randn(g, 3, 4, 64, 32)                                  # per-member w: a launch each
    before = gmm.launches
    got = torch.func.vmap(gmm.grouped_matmul)(x, ws)
    assert gmm.launches == before + 3
    torch.testing.assert_close(got, torch.stack([ref.grouped_matmul_ref(x[i], ws[i])
                                                 for i in range(3)]), atol=1e-4, rtol=2e-5)
    xs, b, lda = _randn(g, 3, 4, 32, 16), _randn(g, 2, 32, 8), -_randn(g, 3, 4, 32).abs()
    before = ssd_scan.launches
    got = torch.func.vmap(lambda a, l_: ssd_scan.ssd_intra_chunk(a, b, b, l_, 16))(xs, lda)
    assert ssd_scan.launches == before + 1
    for i in range(3):
        for o, want in zip(got, ref.ssd_intra_chunk_ref(xs[i], b, b, lda[i], 16)):
            torch.testing.assert_close(o[i], want, atol=1e-4, rtol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(4, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        rms.rmsnorm(x.t(), torch.ones(4, device="cuda"))
    x = torch.zeros(2, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        gmm.grouped_matmul(x, torch.zeros(2, 4, 16, device="cuda").transpose(1, 2))
    xs = torch.zeros(2, 512, 16, device="cuda")
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_intra_chunk(xs, xs, xs, xs[..., 0], 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_kernels_match_plain_versions(arch):
    from repro_torch.launch.serve import prompt_batch

    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    batch = prompt_batch(cfg, 2, 40, 1, "cuda")
    with torch.no_grad():
        got = M.greedy_decode(params, cfg, batch, 5, 48)
        with registry.kernel_mode_scope("ref"):
            want = M.greedy_decode(params, cfg, batch, 5, 48)
        logits, _, _ = M.prefill(params, cfg, batch, 48)
        with registry.kernel_mode_scope("ref"):
            logits_ref, _, _ = M.prefill(params, cfg, batch, 48)
    torch.testing.assert_close(logits, logits_ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, want)


def test_moe_layer_gives_the_same_bits_every_run():
    """qwen3-moe's MoE layer at full width (8 choices a token) on a prefill of
    4 x 512 tokens: four runs give the same bits, because the combine adds
    each token's rows in a fixed order."""
    from repro_torch.models import moe
    cfg = get_config("qwen3-moe-30b-a3b")
    layer = moe.MoE(cfg, device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * p.shape[-2] ** -0.5)
        x = _randn(g, 4, 512, cfg.d_model, dtype=cfg.compute_dtype)
        outs = [moe.moe_apply(layer, cfg, x)[0] for _ in range(4)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


# ------------------------------------------- the served models' new shapes

def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,kw", [
    (4, 1500, 1500, 12, 12, {"causal": False}),     # whisper's encoder: 11 key tiles + 92
    (4, 512, 1500, 12, 12, {"causal": False}),      # whisper's cross-attention at prefill
    (4, 2048, 2048, 25, 5, {"window": 1024}),       # hymba: GQA 5 under its window
    (4, 512, 512, 36, 36, {})])                     # minicpm: MHA at head dim 64
def test_flash_attention_at_the_new_models_shapes(B, Sq, Sk, Hq, Hkv, kw):
    g = torch.Generator("cuda").manual_seed(0)
    bf16 = torch.bfloat16
    q = _randn(g, B, Sq, Hq, 64, dtype=bf16)
    k, v = _randn(g, B, Sk, Hkv, 64, dtype=bf16), _randn(g, B, Sk, Hkv, 64, dtype=bf16)
    got = _one_launch_of(fa, fa.KERNELS[0], lambda: fa.flash_attention(q, k, v, **kw))
    torch.testing.assert_close(got.float(), ref.attention_ref(q, k, v, **kw).float(),
                               atol=TOL[bf16], rtol=TOL[bf16])


def test_rmsnorm_at_hymba_width_takes_the_register_resident_kernel():
    g = torch.Generator("cuda").manual_seed(0)
    x, w = _randn(g, 2048, 1600, dtype=torch.bfloat16), _randn(g, 1600)
    got = _one_launch_of(rms, rms.KERNELS[0], lambda: rms.rmsnorm(x, w))
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(),
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


def test_grouped_matmul_at_llama4_shape():
    """16 experts, top-1, capacity 160 at 2048 tokens: 5120 -> 8192."""
    g = torch.Generator("cuda").manual_seed(0)
    bf16 = torch.bfloat16
    x = _randn(g, 16, 160, 5120, dtype=bf16) * 0.3
    w = _randn(g, 16, 5120, 8192, dtype=bf16) * 0.3
    got = _one_launch_of(gmm, gmm.KERNELS[0], lambda: gmm.grouped_matmul(x, w))
    want = ref.grouped_matmul_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[bf16] * 5120, rtol=TOL[bf16])
    assert _rel_l2(got, want) <= 5e-3


def test_ssd_at_hymba_shape():
    """50 heads of 64, state 16, chunk 128 (the tensor-core kernel)."""
    g = torch.Generator("cuda").manual_seed(0)
    Bz, S, H, P, G, N = 4, 512, 50, 64, 1, 16
    x = _randn(g, Bz, S, H, P)
    dt = _randn(g, Bz, S, H).abs() * 0.1 + 0.01
    A = -_randn(g, H).abs() - 0.1
    Bm, Cm = _randn(g, Bz, S, G, N) * 0.5, _randn(g, Bz, S, G, N) * 0.5
    D = _randn(g, H)
    y, h = _one_launch_of(ssd_scan, ssd_scan.KERNELS[0],
                          lambda: ssd_scan.ssd(x, dt, A, Bm, Cm, D=D, chunk=128))
    want_y, want_h = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D=D, chunk=128)
    torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(h, want_h, atol=1e-3, rtol=1e-3)


def _full_width_layer(arch):
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    block = T.Block(cfg, "cuda")
    g = torch.Generator("cuda").manual_seed(0)
    for mod in block.modules():
        if hasattr(mod, "init_"):
            mod.init_(g)
    return cfg, block, g


def test_hymba_layer_kernels_match_plain_versions():
    """One full-width hymba block (attention ∥ SSM, the register-resident
    RMSNorm at d 1600) on 2 x 512 tokens, bf16: relative L2 <= 2e-2."""
    from repro_torch.models import transformer as T

    cfg, block, g = _full_width_layer("hymba-1.5b")
    x = _randn(g, 2, 512, cfg.d_model, dtype=torch.bfloat16)
    pos = torch.arange(512, device="cuda", dtype=torch.int32)[None].expand(2, 512)
    before = rms.launches_by_kernel[rms.KERNELS[0]], ssd_scan.launches
    first = rms.launches_by_kernel[rms.KERNELS[1]]
    with torch.no_grad():
        got, _, _ = T.block_apply(block, cfg, x, pos, layer_idx=0)
        with registry.kernel_mode_scope("ref"):
            want, _, _ = T.block_apply(block, cfg, x, pos, layer_idx=0)
    assert rms.launches_by_kernel[rms.KERNELS[0]] > before[0] and ssd_scan.launches > before[1]
    assert rms.launches_by_kernel[rms.KERNELS[1]] == first
    assert torch.isfinite(got.float()).all() and _rel_l2(got, want) <= 2e-2


def test_whisper_decoder_layer_with_cross_attention_matches_plain_versions():
    """One full-width whisper decoder block with cross-attention to 1500
    encoder frames (non-causal flash attention, Sq 512 != Sk 1500), bf16."""
    from repro_torch.models import transformer as T

    cfg, block, g = _full_width_layer("whisper-small")
    x = _randn(g, 2, 512, cfg.d_model, dtype=torch.bfloat16)
    enc = _randn(g, 2, cfg.encoder_seq, cfg.d_model, dtype=torch.bfloat16)
    pos = torch.arange(512, device="cuda", dtype=torch.int32)[None].expand(2, 512)
    before = fa.launches_by_kernel[fa.KERNELS[0]]
    with torch.no_grad():
        got, _, _ = T.block_apply(block, cfg, x, pos, layer_idx=0, enc_out=enc)
        with registry.kernel_mode_scope("ref"):
            want, _, _ = T.block_apply(block, cfg, x, pos, layer_idx=0, enc_out=enc)
    assert fa.launches_by_kernel[fa.KERNELS[0]] == before + 2   # self and cross
    assert torch.isfinite(got.float()).all() and _rel_l2(got, want) <= 2e-2


def test_captured_whisper_decode_step_equals_uncaptured():
    """whisper-small at full width, 2 layers a stack: a served decode step of
    3 tenants replayed from a CUDA graph gives the uncaptured step's bits."""
    from repro_torch.core import TDG, clear_intern_cache
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.serving import RegionServer
    from repro_torch.training import make_serve_step

    cfg = dataclasses.replace(get_config("whisper-small"), num_layers=2, encoder_layers=2)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    decode = make_serve_step(cfg)
    with torch.no_grad():
        states = [M.prefill(params, cfg, prompt_batch(cfg, 2, 64, 1 + i, "cuda"), 80)
                  for i in range(3)]
    outs = {}
    for capture in (True, False):
        clear_intern_cache()
        server = RegionServer(max_batch=4, max_wait_ms=5.0, autostart=False, capture=capture)
        for i in range(3):
            tdg = TDG(f"decode[{i}]")
            tdg.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                         outs=["next", "caches"], name="decode")
            server.register_tenant(f"t{i}", tdg, outputs=("next", "caches"))
        futs = [server.submit(f"t{i}", {
            "params": params, "caches": c, "pos": p,
            "tokens": torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]})
            for i, (lg, c, p) in enumerate(states)]
        server.start()
        outs[capture] = [f.result(timeout=300) for f in futs]
        graphs = server.stats()["graphs"]["captures"]
        server.close()
        assert (graphs > 0) == capture
    for a, b in zip(outs[True], outs[False]):
        for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y)
    clear_intern_cache()


# ------------------------------------------------- CUDA-graph replay of regions

def _graph_region(name, **sizes):
    from repro_torch import workloads as W
    return W.WORKLOADS[name](**sizes, device="cuda")


@pytest.mark.parametrize("name,sizes,rel", [
    ("heat", {"n": 256, "nb": 8}, 1e-6),
    ("cholesky", {"n": 512, "nb": 4}, 1e-5),
    ("rmsnorm", {"n_tokens": 1024, "d": 2048, "nb": 8, "dtype": torch.bfloat16}, 2e-2),
    ("attention", {"n_seqs": 8, "seq": 256, "heads": 8, "head_dim": 128, "nb": 4,
                   "dtype": torch.bfloat16}, 2e-2),
    ("attention", {"n_seqs": 8, "seq": 128, "heads": 4, "head_dim": 64, "nb": 4}, 2e-5)])
def test_captured_replay_matches_uncaptured_and_eager(name, sizes, rel):
    from repro_torch.core import EagerExecutor, ReplayExecutor, clear_intern_cache, lower_tdg
    tdg, bufs, verify = _graph_region(name, **sizes)
    captured = ReplayExecutor(tdg).run(bufs)
    uncaptured = lower_tdg(tdg, jit=False)(dict(bufs))
    eager = EagerExecutor(tdg, n_workers=4).run(dict(bufs))
    verify(captured)
    for other in (uncaptured, eager):
        for k, v in other.items():
            scale = v.float().abs().max().item()
            assert (captured[k].float() - v.float()).abs().max().item() <= rel * scale, k
    clear_intern_cache()


def test_capture_once_per_signature():
    from repro_torch.core import TDG, clear_intern_cache, lower_tdg
    tdg = TDG("sig")
    step = lambda x: torch.tanh(x @ x.T) @ x  # noqa: E731
    for t in range(4):
        tdg.add_task(step, inouts=[f"x{t}"])
    fn = lower_tdg(tdg)
    g = torch.Generator("cuda").manual_seed(0)
    small = {f"x{t}": _randn(g, 8, 8) for t in range(4)}
    large = {f"x{t}": _randn(g, 16, 16) for t in range(4)}
    fn(small)
    fn(small)
    assert fn.graph_replay.captures == 1
    out = fn(large)
    assert fn.graph_replay.captures == 2
    fn(small)
    assert fn.graph_replay.captures == 2
    want = lower_tdg(tdg, jit=False)(dict(large))
    for k in want:
        torch.testing.assert_close(out[k], want[k], atol=1e-5, rtol=1e-5)
    clear_intern_cache()


def test_replay_spans_time_each_part_of_a_captured_call():
    """With spans on, a captured call records ``replay.key``, then at its
    first call ``replay.capture``, then ``replay.copy_in``, ``replay.launch``
    and ``replay.copy_out`` in that order; a second call captures nothing;
    a served step's replay spans fall inside its ``step`` span."""
    from repro_torch.core import TDG, clear_intern_cache, lower_tdg, spans
    tdg = TDG("spans")
    tdg.add_task(lambda x, w: torch.tanh(x @ w), ins=["x", "w"], outs=["y"])
    fn = lower_tdg(tdg)
    g = torch.Generator("cuda").manual_seed(1)
    bufs = {"x": _randn(g, 8, 8), "w": _randn(g, 8, 8)}
    spans.enable()
    try:
        fn(bufs)
        fn(bufs)
        recs = [r for r in spans.snapshot() if r["name"].startswith("replay.")]
        server, reqs, _ = _served(_mix)
        for f in server.submit_many([(f"t{i}", r) for i, r in enumerate(reqs)]):
            f.result(120)
        server.close()
        served = spans.snapshot()
    finally:
        spans.disable()
    names = [r["name"] for r in recs]
    assert names == ["replay.key", "replay.capture", "replay.copy_in", "replay.launch",
                     "replay.copy_out", "replay.key", "replay.copy_in", "replay.launch",
                     "replay.copy_out"]
    assert recs[0]["args"]["leaves"] == 2 and recs[1]["args"]["leaves"] == 2
    assert all(a["t1"] <= b["t0"] for a, b in zip(recs, recs[1:]))
    steps = [r for r in served if r["name"] == "step"]
    launches = [r for r in served if r["name"] == "replay.launch"
                and r["thread"] == server._thread.name]
    assert steps and launches
    for launch in launches:
        assert any(s["t0"] <= launch["t0"] <= launch["t1"] <= s["t1"] for s in steps)
    assert server.stats()["graphs"]["evictions"] == 0
    clear_intern_cache()


def test_host_sync_makes_the_capture_raise():
    from repro_torch.core import TDG, GraphCaptureError, ReplayExecutor, clear_intern_cache
    tdg = TDG("sync")
    tdg.add_task(lambda x: x * 2, inouts=["x"], name="double")
    tdg.add_task(lambda x: x + x.sum().item(), inouts=["x"], name="readback")
    with pytest.raises(GraphCaptureError, match="readback"):
        ReplayExecutor(tdg).run({"x": torch.ones(4, device="cuda")})
    # no fallback, and the card still works
    assert torch.equal(torch.ones(3, device="cuda") * 2, torch.full((3,), 2.0, device="cuda"))
    clear_intern_cache()


def test_outputs_survive_the_next_replay():
    from repro_torch.core import TDG, clear_intern_cache, lower_tdg
    tdg = TDG("fresh")
    tdg.add_task(lambda x: x * 3.0, ins=["x"], outs=["y"])
    tdg.add_task(lambda x: x + 1.0, ins=["x"], outs=["z"])
    fn = lower_tdg(tdg)
    a = fn({"x": torch.ones(16, device="cuda")})
    b = fn({"x": torch.full((16,), 5.0, device="cuda")})
    assert torch.equal(a["y"], torch.full((16,), 3.0, device="cuda"))
    assert torch.equal(a["z"], torch.full((16,), 2.0, device="cuda"))
    assert torch.equal(b["y"], torch.full((16,), 15.0, device="cuda"))
    assert a["y"].data_ptr() != b["y"].data_ptr()
    clear_intern_cache()


@pytest.mark.parametrize("name,sizes,mod,kernel,symbol", [
    ("rmsnorm", {"n_tokens": 2048, "d": 2048, "nb": 8, "dtype": torch.bfloat16},
     rms, "rmsnorm_sm90", "rmsnorm_sm90_kernel"),
    ("attention", {"n_seqs": 8, "seq": 256, "heads": 8, "head_dim": 128, "nb": 4,
                   "dtype": torch.bfloat16}, fa, "flash_attention_sm90", "fa_sm90_kernel"),
    ("attention", {"n_seqs": 8, "seq": 128, "heads": 4, "head_dim": 64, "nb": 4},
     fa, "flash_attention_sm90", "fa_sm90_tf32_kernel")])
def test_kernels_launch_inside_the_captured_graph(name, sizes, mod, kernel, symbol):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ReplayExecutor, clear_intern_cache, lower_tdg
    tdg, bufs, _ = _graph_region(name, **sizes)
    plain = lower_tdg(tdg, jit=False)
    before = dict(mod.launches_by_kernel)
    plain(dict(bufs))
    per_replay = mod.launches_by_kernel[kernel] - before[kernel]
    assert per_replay >= 1
    assert all(c.fused and c.batcher == "vmap" for c in plain.last_plan.classes)
    ex = ReplayExecutor(tdg)
    before = mod.launches_by_kernel[kernel]
    ex.run(bufs)                                   # warm-up + capture
    assert mod.launches_by_kernel[kernel] - before == 2 * per_replay
    before = mod.launches_by_kernel[kernel]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex.run(bufs)                               # a replay counts nothing
        torch.cuda.synchronize()
    assert mod.launches_by_kernel[kernel] == before
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert any(symbol in n for n in names), sorted(names)
    clear_intern_cache()


def test_cpu_scalar_keys_the_graph_by_value():
    from repro_torch.core import TDG, clear_intern_cache, lower_tdg
    tdg = TDG("scale")
    tdg.add_task(lambda x, a: x * a, ins=["x", "a"], outs=["y"])
    fn = lower_tdg(tdg)
    x = torch.ones(4, device="cuda")
    assert torch.equal(fn({"x": x, "a": torch.tensor(2.0)})["y"], 2 * x)
    assert torch.equal(fn({"x": x, "a": torch.tensor(3.0)})["y"], 3 * x)
    assert fn.graph_replay.captures == 2
    clear_intern_cache()


# ------------------------------------------- donation, graph memory, served steps

def _donating_region():
    from repro_torch.core import TDG
    tdg = TDG("donate")
    tdg.add_task(lambda s, g: torch.tanh(s @ g) + s, ins=["state", "g"], outs=["state"])
    tdg.add_task(lambda g: g * 2.0, ins=["g"], outs=["y"])
    return tdg


@pytest.mark.parametrize("intern", [True, False])
def test_donated_slot_round_trips_without_a_copy(intern):
    from repro_torch.core import clear_intern_cache, lower_tdg
    tdg = _donating_region()
    fn = lower_tdg(tdg, donate_slots=("state",), intern=intern)
    replay = fn.graph_replay if intern else fn
    plain = lower_tdg(tdg, jit=False)
    gen = torch.Generator("cuda").manual_seed(3)
    state, g = _randn(gen, 16, 16) * 0.1, _randn(gen, 16, 16) * 0.1
    for step in range(4):
        want = plain({"state": state.clone(), "g": g})
        ptr = state.data_ptr()
        out = fn({"state": state, "g": g})
        assert out["state"] is state and state.data_ptr() == ptr   # written in place
        assert torch.equal(state, want["state"]) and torch.equal(out["y"], want["y"])
        (entry,) = replay._graphs.values()
        assert len(entry.static_in) == 1 and entry.static_in[0].data_ptr() != ptr  # g only
    assert replay.captures == 1                  # passed back: the same graph, no copy in
    other = state.clone()
    fn({"state": other, "g": g})                 # a tensor it has not seen: captured once more
    assert replay.captures == 2 and torch.equal(other, plain({"state": state, "g": g})["state"])
    clear_intern_cache()


def test_graphs_are_bounded_and_released():
    from repro_torch.core import TDG, clear_intern_cache, lower, lower_tdg
    tdg = TDG("lru")
    tdg.add_task(lambda x: x * 2.0 + 1.0, inouts=["x"])
    fn = lower_tdg(tdg)
    extra = 3
    for n in range(lower._GRAPH_CAP + extra):
        out = fn({"x": torch.full((n + 1,), float(n), device="cuda")})
        assert torch.equal(out["x"], torch.full((n + 1,), 2.0 * n + 1.0, device="cuda"))
    replay = fn.graph_replay
    assert len(replay) == lower._GRAPH_CAP and replay.evictions == extra
    clear_intern_cache()
    assert len(replay) == 0


def _served(fn, n=4, **server_kw):
    """n tenants of a one-task region over a shared weight; the server,
    inputs, and what each input gives uncaptured."""
    from repro_torch.core import TDG, lower_tdg
    from repro_torch.serving import RegionServer
    server = RegionServer(max_batch=n, **{"max_wait_ms": 5, **server_kw})
    gen = torch.Generator("cuda").manual_seed(4)
    w = _randn(gen, 32, 32) * 0.2
    reqs = []
    for i in range(n):
        tdg = TDG(f"served[{i}]")
        tdg.add_task(fn, ins=["x", "w"], outs=["x"])
        server.register_tenant(f"t{i}", tdg)
        reqs.append({"x": _randn(gen, 8, 32), "w": w})
    plain = lower_tdg(tdg, jit=False)
    return server, reqs, plain


def _mix(x, w):
    return torch.tanh(x @ w) * 0.5 + x


def test_capture_from_the_scheduler_thread_while_clients_issue_device_ops():
    import threading
    from repro_torch.core import clear_intern_cache
    stop, errors = threading.Event(), []

    def noise():
        try:
            y = torch.ones(4096, device="cuda")
            while not stop.is_set():
                y = y + 1                 # small ops on the default stream, all along
        except Exception as e:            # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=noise) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        server, reqs, plain = _served(_mix)
        outs = []
        for _ in range(3):
            futs = server.submit_many([(f"t{i}", r) for i, r in enumerate(reqs)])
            outs = [f.result(120) for f in futs]
        stats = server.stats()
        server.close()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors and stats["graphs"]["captures"] >= 1
    assert stats["metrics"]["batch_fallbacks"] == 0 and stats["metrics"]["failed"] == 0
    for r, out in zip(reqs, outs):
        torch.testing.assert_close(out["x"], plain(dict(r))["x"], atol=2e-5, rtol=2e-5)
    clear_intern_cache()


def test_server_close_releases_every_graph():
    from repro_torch.core import clear_intern_cache
    server, reqs, _ = _served(_mix)
    for f in server.submit_many([(f"t{i}", r) for i, r in enumerate(reqs)]):
        f.result(120)
    f = server.submit("t0", reqs[0])
    f.result(120)
    assert server.stats()["graphs"]["held"] >= 1
    server.close()
    assert server.stats()["graphs"]["held"] == 0
    clear_intern_cache()


def test_a_failed_capture_fails_the_batch_and_is_no_fallback():
    from repro_torch.core import GraphCaptureError, clear_intern_cache

    def syncs(x, w):
        torch.cuda.synchronize()          # fine uncaptured and under vmap; not in a capture
        return _mix(x, w)

    server, reqs, _ = _served(syncs, continuous=False, max_wait_ms=0, autostart=False)
    futs = [server.submit(f"t{i}", r) for i, r in enumerate(reqs)]
    server.start()
    for f in futs:
        with pytest.raises(GraphCaptureError):
            f.result(120)
    server.close()
    m = server.stats()["metrics"]
    assert m["batch_fallbacks"] == 0 and m["failed"] == len(reqs) and m["completed"] == 0
    clear_intern_cache()


def test_captured_and_uncaptured_steps_are_equal():
    from repro_torch.core import clear_intern_cache
    outs = {}
    for capture in (True, False):
        server, reqs, _ = _served(_mix, autostart=False, capture=capture)
        futs = [server.submit(f"t{i}", r) for i, r in enumerate(reqs)]
        server.start()
        outs[capture] = [f.result(120)["x"] for f in futs]
        server.close()
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    clear_intern_cache()


# ---------------------------------------------------------------- training

def _grads_of(fn, inputs, cots):
    xs = [t.detach().requires_grad_() for t in inputs]
    out = fn(*xs)
    return torch.autograd.grad(out if isinstance(out, tuple) else (out,), xs, cots)


def _rule_cases(g, dtype):
    x, w, r = _randn(g, 3, 40, 128, dtype=dtype), _randn(g, 128), _randn(g, 3, 40, 128, dtype=dtype)
    q = _randn(g, 2, 96, 8, 64, dtype=dtype)
    k, v = _randn(g, 2, 96, 2, 64, dtype=dtype), _randn(g, 2, 96, 2, 64, dtype=dtype)
    xg, wg = _randn(g, 4, 24, 64, dtype=dtype), _randn(g, 4, 64, 40, dtype=dtype)
    xs, b, c = _randn(g, 8, 64, 16) * 0.3, _randn(g, 2, 64, 16) * 0.5, _randn(g, 2, 64, 16) * 0.5
    lda = -_randn(g, 8, 64).abs() * 0.2
    return {
        "rmsnorm": (rms, lambda a, b_, c_: rms.rmsnorm(a, b_, residual=c_),
                    lambda a, b_, c_: ref.rmsnorm_ref(a, b_, residual=c_), [x, w, r]),
        "flash_attention": (fa, lambda a, b_, c_: fa.flash_attention(a, b_, c_, window=40),
                            lambda a, b_, c_: ref.attention_ref(a, b_, c_, window=40), [q, k, v]),
        "grouped_matmul": (gmm, gmm.grouped_matmul, ref.grouped_matmul_ref, [xg, wg]),
        "ssd_intra_chunk": (ssd_scan, lambda *a: ssd_scan.ssd_intra_chunk(*a, 32),
                            lambda *a: ref.ssd_intra_chunk_ref(*a, 32), [xs, b, c, lda]),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "grouped_matmul",
                                  "ssd_intra_chunk"])
def test_backward_rule_on_the_kernel_path(name, dtype):
    """The kernel's forward and the op's backward rule against the plain
    forward and autograd; the forward is the kernel (its count rises)."""
    if name == "ssd_intra_chunk" and dtype == torch.bfloat16:
        pytest.skip("the SSD kernel takes f32 only")
    g = torch.Generator("cuda").manual_seed(11)
    mod, kernel_fn, plain_fn, inputs = _rule_cases(g, dtype)[name]
    with torch.no_grad():
        outs = kernel_fn(*inputs)
    cots = [torch.randn_like(o) for o in (outs if isinstance(outs, tuple) else (outs,))]
    before = mod.launches
    got = _grads_of(kernel_fn, inputs, cots)
    assert mod.launches == before + 1
    want = _grads_of(plain_fn, inputs, cots)
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= TOL[dtype] * scale
    x = inputs[0].detach().requires_grad_()       # torch.func.vjp takes the rule too
    out, vjp = torch.func.vjp(lambda a: kernel_fn(a, *inputs[1:]), x)
    (gx,) = vjp(tuple(cots) if isinstance(out, tuple) else cots[0])
    torch.testing.assert_close(gx, got[0])


def _train_setup(**kw):
    from repro_torch.optim import adamw

    cfg = reduced(get_config("qwen2.5-3b"), num_layers=2, **kw)
    params = M.params_of(M.init_params(cfg, torch.Generator("cuda").manual_seed(0)))
    toks = torch.randint(2, cfg.vocab_size, (2, 32), generator=torch.Generator("cuda").manual_seed(1),
                         device="cuda", dtype=torch.int32)
    return cfg, params, adamw(1e-2), toks


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def test_captured_train_region_equals_uncaptured_and_keeps_donated_buffers():
    from repro_torch.core import EagerExecutor, lower_tdg, reset_registry
    from repro_torch.training import make_tdg_train_region

    reset_registry()
    cfg, params, opt, toks = _train_setup(dtype="bfloat16")
    region = make_tdg_train_region(cfg, opt, name="cuda train region")
    outs = ("params", "opt_state", "loss")
    rec = region(params=params, opt_state=opt.init(params), tokens=toks)
    unc = lower_tdg(region.tdg, jit=False, outputs=outs)(
        {"params": params, "opt_state": opt.init(params), "tokens": toks})
    eager = EagerExecutor(region.tdg).run(
        {"params": params, "opt_state": opt.init(params), "tokens": toks}, outputs=list(outs))
    p, s = _clone_tree(params), opt.init(params)
    for i in range(3):
        out = region(params=p, opt_state=s, tokens=toks)
        assert all(out["params"][k] is p[k] for k in p)           # written in place, no copy
        assert out["opt_state"]["step"] is s["step"]
        if i == 0:
            for k in p:
                torch.testing.assert_close(out["params"][k], unc["params"][k], atol=0, rtol=0)
                torch.testing.assert_close(out["params"][k], eager["params"][k], atol=0, rtol=0)
            torch.testing.assert_close(out["loss"], unc["loss"], atol=0, rtol=0)
            torch.testing.assert_close(rec["loss"], unc["loss"], atol=0, rtol=0)
        p, s = out["params"], out["opt_state"]
    graph = next(iter(region._replay_cache.values())).graph_replay
    assert graph.captures == 1 and int(s["step"]) == 3
    reset_registry()


def test_fused_train_step_matches_plain_versions():
    from repro_torch.training import make_train_step

    cfg, params, opt, toks = _train_setup(dtype="bfloat16", remat="full")
    step = make_train_step(cfg, opt)
    _, _, m = step(_clone_tree(params), opt.init(params), {"tokens": toks})
    with registry.kernel_mode_scope("ref"):
        _, _, mp = step(_clone_tree(params), opt.init(params), {"tokens": toks})
    for k in ("loss", "grad_norm"):
        assert abs(m[k].item() - mp[k].item()) <= 2e-2 * abs(mp[k].item())


def test_checkpoint_saved_while_the_next_in_place_step_runs(tmp_path):
    """save() snapshots synchronously; the in-place step launched right after
    it (while the background thread writes) does not reach the checkpoint."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.training import make_train_step

    cfg, params, opt, toks = _train_setup()
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    params, state, _ = step(params, state, {"tokens": toks})
    snapshot = {"params": _clone_tree(params), "opt_state": _clone_tree(state)}
    ck = Checkpointer(tmp_path)
    ck.save({"params": params, "opt_state": state}, 1)
    params, state, _ = step(params, state, {"tokens": toks})       # overwrites in place
    restored, at = ck.restore({"params": params, "opt_state": state})
    assert at == 1
    for part in ("params", "opt_state"):
        for k, v in snapshot[part].items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    assert torch.equal(restored[part][k][kk], vv)
            else:
                assert torch.equal(restored[part][k], v)
    assert not torch.equal(restored["params"]["embed.table"], params["embed.table"])


# ------------------------------------------------ exported replay programs

def _decode_setup():
    from repro_torch.launch import serve
    from repro_torch.models import model as Mm

    reg = serve.build_decode_registry(smoke=True, device="cuda")
    cfg = serve.build_config("qwen2.5-3b", True)
    params = Mm.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    batch = serve.prompt_batch(cfg, 2, 8, 1, "cuda")
    with torch.no_grad():
        logits, caches, pos = Mm.prefill(params, cfg, batch, 12)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    from repro_torch.core import TDG
    tdg = TDG("decode[0]")
    tdg.add_task(reg.get("decode"), ins=["params", "tokens", "pos", "caches"],
                 outs=["next", "caches"], name="decode")
    bufs = {"params": Mm.params_of(params), "tokens": tok[:, None], "pos": pos,
            "caches": caches}
    return tdg, bufs


def test_exported_decode_step_keeps_the_kernels_ops():
    from repro_torch.core import aot_compile_tdg
    tdg, bufs = _decode_setup()
    aot = aot_compile_tdg(tdg, bufs)
    code = aot.program.graph_module.code
    assert "torch.ops.repro_torch.rmsnorm.default" in code
    assert aot.device.type == "cuda" and aot.cost_analysis["flops"] > 0


def test_hydrated_replay_is_bitwise_the_lowered_replay():
    from repro_torch.core import aot_compile_tdg, executable_from_bytes, executable_to_bytes
    from repro_torch.core import lower
    tdg, bufs = _decode_setup()
    hydrated = executable_from_bytes(executable_to_bytes(aot_compile_tdg(tdg, bufs)),
                                     device="cuda")
    with torch.no_grad():
        want = lower.lower_tdg(tdg)(dict(bufs))
        first = hydrated(bufs)                  # captures a CUDA graph
        again = hydrated(bufs)                  # replays it
    assert hydrated.replay.captures == 1
    for got in (first, again):
        assert torch.equal(got["next"], want["next"])
        for a, b in zip(torch.utils._pytree.tree_leaves(got["caches"]),
                        torch.utils._pytree.tree_leaves(want["caches"])):
            assert torch.equal(a, b)


def test_bf16_cuda_tensor_roundtrips_the_codec():
    from repro_torch.serving import rpc
    x = torch.randn(3, 5, device="cuda").to(torch.bfloat16)
    for codec in ("json", "binary"):
        back = rpc.decode(rpc.encode({"x": x, "s": x[0, 0]}, codec))
        assert back["x"].device.type == "cpu" and back["x"].dtype == torch.bfloat16
        assert torch.equal(back["x"], x.cpu()) and back["s"].shape == ()


_FIRST_CALLS = """
import sys, torch
from repro_torch.kernels import flash_attention as fa, moe_gmm as gmm, rmsnorm as rms, ssd_scan
x, w = torch.randn(3, 8, 64, device="cuda"), torch.ones(64, device="cuda")
rms.rmsnorm(x, w)
torch.func.vmap(lambda a: rms.rmsnorm(a, w))(x)
xg = x.clone().requires_grad_()
rms.rmsnorm(xg, w).sum().backward()
q = torch.randn(1, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
fa.flash_attention(q, q, q)
gmm.grouped_matmul(torch.randn(2, 8, 16, device="cuda"), torch.randn(2, 16, 24, device="cuda"))
b = torch.randn(2, 32, 8, device="cuda")
ssd_scan.ssd_intra_chunk(torch.randn(4, 32, 16, device="cuda"), b, b,
                         -torch.rand(4, 32, device="cuda"), 16)
torch.cuda.synchronize()
print("torch._dynamo" in sys.modules)
"""


def test_the_kernels_first_calls_load_no_compiler():
    """The ops are registered as they are (``_autograd.cuda_op``): each
    kernel's first launches, direct, under vmap and under autograd, load no
    ``torch._dynamo``, which a ``custom_op`` kernel's first call imports
    (seconds of a server's set-up)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", _FIRST_CALLS], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "False"
