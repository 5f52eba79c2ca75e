"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed. On the card, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared ``tests/conftest.py`` imports the JAX package.)
Each kernel is held against its plain version (atol = rtol = 2e-5 in f32,
2e-2 in bf16; grouped matmul at atol = TOL·d, rtol = TOL; SSD at 1e-3),
under ``torch.func.vmap`` too, and the reduced models of the three ported
families are run with the kernels and with the plain versions. Each
attention, grouped-matmul, RMSNorm and SSD case of the redesigned kernels
also checks that the kernel ``kernel_for`` picks (TMA + wgmma, rows in
registers, 3xTF32 tensor cores at the shapes they take; the first design
otherwise) is the one whose count rose. Regions replayed from a captured
CUDA graph (``lower_tdg(jit=True)``) must equal the uncaptured replay and
eager, capture once per buffer signature, raise when a payload syncs the
host, return outputs the next replay leaves alone, and launch the RMSNorm
and flash-attention kernels inside the graph.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
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
    (2, 200, 200, 4, 2, 64, {}), (2, 200, 200, 4, 2, 128, {})])
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
    ((33, 1000), torch.float32, torch.float32, False),           # the first design
    ((5, 16), torch.float32, torch.float32, True)])
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


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m"])
def test_reduced_model_kernels_match_plain_versions(arch):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
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
     fa, "flash_attention", "fa_fwd_kernel")])
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
