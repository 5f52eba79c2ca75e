"""granite-4.0-h-small in the benchmark: its architecture module against the
program's model at full widths (on the meta device: no memory) and its
counts, the kernel work of the two new roofline shares against the port's
kernel table, the three new readers on synthetic traces and spans (and
nothing without them), the reference's imports, and a tiny Granite served
through ``harness.System`` and held to the reference by ``check``."""
import ast
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import check, harness, trace, work
from portbench.arch import granitemoehybrid as G

PKG = Path(__file__).resolve().parents[1]
H100 = work.PEAKS["NVIDIA H100 80GB HBM3"]
SEED = 2**31 + 77


def _conf():
    return json.loads((PKG / "configs" / "granite-4.0-h-small.json").read_text())


def _model(**over) -> dict:
    m = dict(_conf()["model"], **over)
    m["padded_vocab"] = -(-m["vocab_size"] // 256) * 256
    return m


def _reader(name):
    return harness.load_file(PKG / "metrics" / f"{name}.py")


def test_layout_is_the_programs_model_at_full_width():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    m = _model()
    cfg = harness.port_config(m)
    harness.check_layout(G.layout(m), M.Model(cfg, "meta"))
    # the file's model block is the program's registered configuration
    assert cfg == dataclasses.replace(get_config("granite-4.0-h-small"), loss_chunk=0)
    assert G.param_count(m) == 8_425_634_304 == M.param_count(M.Model(cfg, "meta"))


def test_the_file_keeps_the_catalog_keys_and_names_its_cut():
    conf = _conf()
    assert conf["num_local_experts"] == conf["model"]["experts_held"] == 9
    assert conf["published"] == {"num_local_experts": 72, "rms_norm_eps": 1e-05}
    assert conf["reduced"] == ["num_local_experts", "rms_norm_eps"]
    assert conf["mamba_chunk_size"] == conf["model"]["mamba_chunk_size"] == 256
    assert conf["layer_types"] == conf["model"]["layer_types"]
    assert [i for i, k in enumerate(conf["layer_types"]) if k == "attention"] == [5, 15, 25, 35]
    assert conf["deployment"]["chips_per_layer"] * 9 == 72


def test_counts():
    m = _model()
    # a token's held choices: 10 * 9 / 72
    assert G.routed_per_token(m) == 1.25
    per_mamba = 4096 * 16768 + 8192 * 4096
    per_attn = 4096 * 48 * 128 + 4096 * 4096
    ffn = 1.25 * 3 * 4096 * 768 + 3 * 4096 * 1536 + 4096 * 72
    ssm = 2 * 4 * 8448 + 6 * 8192 * 128
    per_token = 2 * (36 * (per_mamba + ffn) + 4 * (per_attn + ffn)) + 36 * ssm
    head = 2 * 100352 * 4096
    assert G.decode_flops(m, 100) == pytest.approx(per_token + 4 * 4 * 32 * 128 * 100 + head)
    assert G.prefill_flops(m, 2, 8) == pytest.approx(
        2 * (8 * per_token + 4 * 4 * 32 * 128 * 36 + head))
    # every f32 weight once (each step's 1 x 10 choices may reach all 9 held)
    assert G.step_param_bytes(m, 1) == 4 * 8_425_634_304
    # KV of 4 layers; conv history and SSD state of 36, read and written
    state = 2 * 36 * (3 * 8448 * 2 + 128 * 64 * 128 * 4)
    assert G.token_cache_bytes(m, 8191) == 8192 * 4 * 2 * 8 * 128 * 2 + state
    assert G.token_cache_bytes(m, 8223) - state == 8224 * 16_384   # 135 MB at 8224 slots


def test_ssd_work_is_the_kernel_tables():
    ssd = _reader("ssd_roofline_pct")
    # BH 128 (4 sequences x 32 heads), S 512, Q 128, P 64, N 128: 52.7 MB bounds it
    flops, nbytes = ssd.launch_work(128, 4, 512, 128, 64, 128)
    assert flops == pytest.approx(1.65e9, rel=2e-3)
    assert round(ssd.launch_seconds(flops, nbytes, H100) * 1e3, 4) == 0.0157
    assert round(3 * flops / (H100["flops"] / 2) * 1e3, 4) == 0.0100


def test_gmm_work_is_the_kernel_tables():
    gmm = _reader("gmm_roofline_pct")
    flops, nbytes = gmm.launch_work(128 * 160, 128, 2048, 768)
    assert round(work.roofline_seconds(flops, nbytes, H100) * 1e3, 4) == 0.1546
    m = _model()
    for product, (a, b) in enumerate(((4096, 768), (4096, 768), (768, 4096))):
        want = work.roofline_seconds(*gmm.launch_work(569, 9, a, b), H100)
        assert gmm.launch_seconds(569, product, m, H100) == want


def _readings(kernels, spans):
    """A window with one 4096-token prefill at [1.0, 1.5] s, traced over [0.5, 2.0]."""
    req = harness.Request(0, 0, 4096, 32, 1)
    served = harness.Served(req, t_send=0.9, t_prefill=1.0, times=[1.5])
    win = harness.Window(0.0, 3.0, [served], [], (0, 0), attempted=1, failed=0, errors=[])
    cell = harness.load_cell("granite-docs")
    tr = None if kernels is None else trace.Trace(0.5, 2.0, kernels)
    r = harness.Readings(cell, cell.model, cell.traffic, win, tr, H100)
    r.spans = spans
    return r


def _moe_span(t0=1.45, routed=(569,) * 40):
    return {"id": 1, "parent": None, "name": "prefill.moe", "thread": "p", "t0": t0,
            "t1": t0 + 0.01, "args": {"routed": list(routed), "rows": [9 * 4096] * 40}}


def test_readers_on_synthetic_traces_and_spans():
    m = _model()
    gmm_k = [trace.Kernel("void gmm_sm90_kernel<...>", 1.0 + i * 1e-3, 1.0 + i * 1e-3 + 2e-4,
                          False) for i in range(120)]
    ssd_k = [trace.Kernel("ssd_chunk_sm90_kernel", 1.2 + i * 1e-3, 1.2 + i * 1e-3 + 5e-4, False)
             for i in range(36)]
    other = [trace.Kernel("gmm_sm90_kernel", 2.5, 2.6, True),          # a decode graph's
             trace.Kernel("ssd_chunk_sm90_kernel", 0.6, 0.7, False)]    # outside the prefill
    r = _readings(gmm_k + ssd_k + other, [_moe_span()])
    gmm = _reader("gmm_roofline_pct")
    layer = sum(gmm.launch_seconds(569, p, m, H100) for p in range(3))
    assert gmm.read(r) == pytest.approx(100 * 40 * layer / (120 * 2e-4))
    ssd = _reader("ssd_roofline_pct")
    want = ssd.launch_seconds(*ssd.launch_work(128, 1, 4096, 128, 64, 128), H100)
    assert ssd.read(r) == pytest.approx(100 * want / 5e-4)
    assert _reader("moe_pad_pct").read(r) == pytest.approx(100 * (1 - 569 / (9 * 4096)))
    # a prefill the trace cuts at its start: its launches in the trace are
    # its last, layer 39's down product last of all
    routed = list(range(500, 540))
    cut = _readings(gmm_k[-4:], [_moe_span(routed=routed)])
    cut.win.served[0].t_prefill = 0.2
    want = (gmm.launch_seconds(538, 2, m, H100)
            + sum(gmm.launch_seconds(539, p, m, H100) for p in range(3)))
    assert gmm.read(cut) == pytest.approx(100 * want / (4 * 2e-4))
    # cut at its end: its first launches, layer 0's first
    cut.win.served[0].t_prefill, cut.win.served[0].times[0] = 1.0, 2.5
    cut.trace.kernels = gmm_k[:2]
    want = gmm.launch_seconds(500, 0, m, H100) + gmm.launch_seconds(500, 1, m, H100)
    assert gmm.read(cut) == pytest.approx(100 * want / (2 * 2e-4))


@pytest.mark.parametrize("name", ["gmm_roofline_pct", "ssd_roofline_pct", "moe_pad_pct"])
def test_readers_read_nothing_without_their_sources(name, monkeypatch):
    """No trace and no spans (a --trace 0 run, or the parent's program):
    nothing; a trace without their kernels, or spans without ``prefill.moe``,
    nothing."""
    from repro_torch.core import spans

    monkeypatch.setattr(spans, "snapshot", lambda: [])
    read = _reader(name).read
    assert read(_readings(None, None)) is None
    assert read(_readings([], [])) is None
    if name != "moe_pad_pct":
        assert read(_readings([trace.Kernel("other", 1.1, 1.2, False)], [_moe_span()])) is None
    if name != "ssd_roofline_pct":
        assert read(_readings([trace.Kernel("gmm_sm90_kernel", 1.1, 1.2, False)], None)) is None


def test_the_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse((PKG / "reference" / "granitemoehybrid.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if node.level == 0 else ".")
    assert names == {"__future__", "contextlib", "torch"}


TINY = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
            layer_types=["mamba", "attention", "mamba", "mamba"], attn_scale=0.0625,
            num_experts=8, top_k=2, moe_d_ff=32, shared_d_ff=48, experts_held=4,
            expert_offset=2, ssm_state=16, ssm_headdim=16, ssm_chunk=8, mamba_chunk_size=16,
            vocab_size=512, dtype="float32")


def test_a_tiny_granite_serves_through_the_harness_and_checks_correct():
    """The cell's own path on the CPU: weights from the arch module's layout,
    bound to the program with nothing missing or over, a closed-loop window
    through prefill and the server's step, then the check against the
    reference, which reads the float32 program's tokens as exact."""
    cell = harness.load_cell("granite-docs")
    cell.config = dict(cell.config, model=dict(cell.config["model"], **TINY))
    cell.traffic = dict(cell.traffic, prompt_len=[9, 20], output_tokens=5, max_len=32,
                        check_sequences=3)
    system = harness.System(cell, SEED, torch.device("cpu"))
    try:
        win = harness.drive(system, SEED, 2.0)
        weights, model = system.weights, cell.model
    finally:
        system.close()
    assert win.failed == 0 and any(s.done for s in win.served)
    picks = check.sample(win.served, SEED, cell.traffic["sequences"], 3)
    ref = check.reference(cell.config)
    gaps, _ = check.gaps(ref, model, weights, picks)
    assert gaps.numel() >= 5 and float(gaps.max()) < 1e-5     # a whole request at least
    # the control rounds every product's inputs to float8: its logits move
    tokens, rows, _ = check._rows(*picks[0])
    exact = ref.logits_at(model, weights, tokens, rows)
    low = ref.logits_at(model, weights, tokens, rows, quant="fp8")
    assert 1e-3 < float((low - exact).abs().max() / exact.abs().max()) < 0.3
