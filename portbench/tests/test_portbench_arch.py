"""The architecture seam: a configuration names the module that lays out its
parameters and counts its work (``arch/<name>.py``), and the harness takes
both from it.

A non-dense configuration needs only new files: here a mixture-of-experts
architecture defined in the test (the port's ``moe`` family at 2 layers, d
64, 8 experts, top-2, one shared expert) is drawn from the seed, bound to the
program's model with nothing missing or over, and served, prefill and
decode, through ``harness.System``. The dense architecture draws exactly
what it drew before it moved to ``arch/dense.py``: the digests below were
taken on the harness before the move.
"""
import hashlib
import json
import math
import types
from pathlib import Path

import pytest
import torch

from portbench import harness, work
from portbench import weights as W
from portbench.arch import dense

PKG = Path(__file__).resolve().parents[1]
SEED = 2**31 + 4321


def _module(name: str, **functions) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__dict__.update(functions)
    return mod


def _model(config: str, **over) -> dict:
    m = dict(json.loads((PKG / "configs" / f"{config}.json").read_text())["model"], **over)
    m["padded_vocab"] = -(-m["vocab_size"] // 256) * 256
    return m


# ---------------------------------------------------------------------------
# The dense draws, pinned to the harness before the move
# ---------------------------------------------------------------------------

#: config -> (buffer length, tensors, sha256 of the JSON list of [offset,
#: name, shape, group] in ``_plan``'s order), at the full configuration.
PLANS = {
    "glm4-9b": (9_399_951_360, 483,
                "f8017515d423585b11d53400f488243d628475b5849a99bef5d75d96b19102df"),
    "minitron-8b": (8_271_433_728, 259,
                    "a2d7b9e221de1d58af3a6c1e0990cdd8a711a381bc0720483938ea94e247f432"),
}
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
             d_ff=256, vocab_size=700, dtype="float32")
#: (config, seed) -> (buffer length, sha256 of the float32 buffer ``make``
#: draws on the CPU) at the SMALL widths.
DRAWS = {
    ("glm4-9b", 7):
        (492_672, "3a975e294fa3e16303b2ba2fb14e0571acc931374ac41be710f6acb36bb3696e"),
    ("glm4-9b", 2**31 + 9):
        (492_672, "94cfed12366bceae50a4efffa736c00ebabce1a065bc799c349bdd5d28d78998"),
    ("minitron-8b", 7):
        (426_624, "29e787bee0b15faea680dbd35dff3f9dc65daef56b8be9a37811ea75f2a72e46"),
    ("minitron-8b", 2**31 + 9):
        (426_624, "6a657e75531c1849107fe48ab715b5f83c1a08d04f07f590d1016ffaf21dde83"),
}


@pytest.mark.parametrize("config", sorted(PLANS))
def test_dense_plan_is_the_parents(config):
    layout = dense.layout(_model(config))
    total, placed, _ = W._plan(layout)
    groups = {name: group for name, _, group in layout}
    rows = [[at, name, list(shape), groups[name]] for at, name, shape in placed]
    digest = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    assert (total, len(rows), digest) == PLANS[config]


@pytest.mark.parametrize("config, seed", sorted(DRAWS))
def test_dense_draw_is_the_parents(config, seed):
    _, buf = W.make(dense.layout(_model(config, **SMALL)), seed, "cpu")
    digest = hashlib.sha256(buf.numpy().tobytes()).hexdigest()
    assert (buf.numel(), digest) == DRAWS[(config, seed)]


# ---------------------------------------------------------------------------
# The configuration names its architecture, and the layout covers the program
# ---------------------------------------------------------------------------

def test_a_configuration_without_arch_fails_at_load(tmp_path):
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    conf = json.loads((PKG / "configs" / "glm4-9b.json").read_text())
    del conf["arch"]
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "glm4-9b.json").write_text(json.dumps(conf))
    with pytest.raises(SystemExit, match='no "arch" key'):
        harness.load_cell("glm4-gen", root=tmp_path)
    assert harness.load_cell("glm4-gen").arch.layout is not None


def _tiny_dense_cell():
    cell = harness.load_cell("glm4-gen")
    model = dict(cell.config["model"], num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, dtype="float32")
    cell.config = dict(cell.config, model=model)
    return cell


@pytest.mark.parametrize("fault, listed", [
    ("missing", "missing ['layers.1.mlp.gate.w']; extra []"),
    ("extra", "missing []; extra ['layers.0.mlp.extra.w']"),
    ("shape", "other shapes ['layers.0.norm1.scale (65,) (program (64,))']"),
])
def test_set_up_stops_where_the_layout_misses_the_program(fault, listed):
    def layout(m):
        out = [it for it in dense.layout(m) if not (fault == "missing"
                                                    and it[0] == "layers.1.mlp.gate.w")]
        if fault == "extra":
            out.append(("layers.0.mlp.extra.w", (m["d_model"], 8), f"w{m['d_model']}"))
        if fault == "shape":
            out = [(n, (65,), g) if n == "layers.0.norm1.scale" else (n, s, g)
                   for n, s, g in out]
        return out

    cell = _tiny_dense_cell()
    cell.arch = _module("arch_broken", layout=layout)
    with pytest.raises(ValueError, match="does not match") as err:
        harness.System(cell, SEED, torch.device("cpu"))
    assert listed in str(err.value)


# ---------------------------------------------------------------------------
# A mixture-of-experts architecture, defined here as arch/<name>.py would be
# ---------------------------------------------------------------------------

MOE = {"name": "moe-tiny", "family": "moe", "num_layers": 2, "d_model": 64,
       "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 512,
       "qk_norm": True, "num_experts": 8, "top_k": 2, "moe_d_ff": 32,
       "num_shared_experts": 1, "capacity_factor": 4.0, "rope_theta": 1e6,
       "mlp": "swiglu", "dtype": "float32", "param_dtype": "float32"}
_BYTES = {"float32": 4, "bfloat16": 2}


def _moe_layout(m):
    d, H, Hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    E, f, V = m["num_experts"], m["moe_d_ff"], m["padded_vocab"]
    out = [("embed.table", (V, d), f"w{d}"), ("head.table", (V, d), f"w{d}"),
           ("final_norm.scale", (d,), "norm")]
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), "norm"), (p + "norm2.scale", (d,), "norm"),
                (p + "attn.wq.w", (d, H * hd), f"w{d}"),
                (p + "attn.wk.w", (d, Hkv * hd), f"w{d}"),
                (p + "attn.wv.w", (d, Hkv * hd), f"w{d}"),
                (p + "attn.wo.w", (H * hd, d), f"w{H * hd}"),
                (p + "attn.qnorm.scale", (hd,), "norm"), (p + "attn.knorm.scale", (hd,), "norm"),
                (p + "moe.router.w", (d, E), f"w{d}"),
                (p + "moe.experts.up.w", (E, d, f), f"w{d}"),
                (p + "moe.experts.gate.w", (E, d, f), f"w{d}"),
                (p + "moe.experts.down.w", (E, f, d), f"w{f}")]
        for s in range(m["num_shared_experts"]):
            out += [(p + f"moe.shared{s}.up.w", (d, f), f"w{d}"),
                    (p + f"moe.shared{s}.gate.w", (d, f), f"w{d}"),
                    (p + f"moe.shared{s}.down.w", (f, d), f"w{f}")]
    return out


def _moe_matmul_params(m, experts):
    """A layer's product weights that a token using ``experts`` routed experts reads."""
    d, H, Hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    ffn = 3 * d * m["moe_d_ff"]
    return (d * (H + 2 * Hkv) * hd + H * hd * d + d * m["num_experts"]
            + (experts + m["num_shared_experts"]) * ffn)


def _moe_param_count(m):
    return sum(math.prod(shape) for _, shape, _ in _moe_layout(m))


def _moe_decode_flops(m, ctx):
    return (2.0 * m["num_layers"] * _moe_matmul_params(m, m["top_k"])
            + 4.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] * ctx
            + 2.0 * m["vocab_size"] * m["d_model"])


def _moe_prefill_flops(m, batch, seq):
    return batch * (2.0 * m["num_layers"] * _moe_matmul_params(m, m["top_k"]) * seq
                    + 4.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] * seq * (seq + 1) / 2
                    + 2.0 * m["vocab_size"] * m["d_model"])


def _moe_step_param_bytes(m, sequences):
    """Every weight but the embedding and the experts no token chose, at
    most ``sequences * top_k`` experts a layer."""
    unused = max(0, m["num_experts"] - sequences * m["top_k"]) * 3 * m["d_model"] * m["moe_d_ff"]
    return _BYTES[m["param_dtype"]] * (_moe_param_count(m) - m["padded_vocab"] * m["d_model"]
                                       - m["num_layers"] * unused + sequences * m["d_model"])


def _moe_token_cache_bytes(m, ctx):
    return (ctx + 1) * m["num_layers"] * 2 * m["num_kv_heads"] * m["head_dim"] * _BYTES[m["dtype"]]


def _moe_cell():
    cell = harness.load_cell("glm4-gen")
    cell.config = {"name": "moe-tiny", "reference": None, "arch": "moe", "model": dict(MOE)}
    cell.arch = _module("arch_moe", layout=_moe_layout, param_count=_moe_param_count,
                        prefill_flops=_moe_prefill_flops, decode_flops=_moe_decode_flops,
                        step_param_bytes=_moe_step_param_bytes,
                        token_cache_bytes=_moe_token_cache_bytes)
    cell.traffic = dict(cell.traffic, sequences=2, prompt_len=[8, 16], output_tokens=6,
                        max_len=32, check_sequences=3)
    return cell


def test_moe_weights_are_the_seeds():
    layout = _moe_layout(_moe_cell().model)
    a, buf = W.make(layout, SEED, "cpu")
    b, _ = W.make(layout, SEED, "cpu")
    c, _ = W.make(layout, SEED + 1, "cpu")
    assert list(a) == [name for name, _, _ in sorted(layout, key=lambda it: it[2])]
    assert all(torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k]) for k in a)
    assert all(a[k].shape == shape and a[k].std() > 0 for k, shape, _ in layout)
    assert all((t.data_ptr() - buf.data_ptr()) % 256 == 0 for t in a.values())
    # the experts' fan-in is their input width: d for up and gate, f for down
    assert a["layers.0.moe.experts.down.w"].abs().max() <= 2 * 32 ** -0.5 + 1e-6
    assert buf.numel() >= _moe_param_count(_moe_cell().model)


def test_moe_binds_every_parameter_and_serves():
    from repro_torch.models import model as M

    cell = _moe_cell()
    system = harness.System(cell, SEED, torch.device("cpu"))
    try:
        bound = dict(system.port.named_parameters())
        assert set(bound) == set(system.weights)
        assert all(bound[n].data_ptr() == t.data_ptr() for n, t in system.weights.items())

        B, V = cell.traffic["sequences"], cell.model["vocab_size"]
        req = harness.Request(0, 0, 12, 6, SEED)
        prompt = harness.prompt_tokens(req, B, V, system.device)
        _, tok, caches, pos = system.prefill(prompt)
        served = [tok]
        with torch.no_grad():
            for _ in range(req.outputs - 1):
                tok, pos, caches = system.step(system.tenants[0], tok, pos, caches)
                served.append(tok)
            # the same prompt, eagerly, one decode_step at a time
            logits, ecaches, epos = M.prefill(system.port, system.cfg, {"tokens": prompt},
                                              cell.traffic["max_len"])
            etok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            eager = [etok]
            for _ in range(req.outputs - 1):
                lg, ecaches = M.decode_step(system.port, system.cfg, etok[:, None], epos, ecaches)
                etok, epos = torch.argmax(lg[:, -1], dim=-1).to(torch.int32), epos + 1
                eager.append(etok)
        assert torch.equal(torch.stack(served, 1), torch.stack(eager, 1))
        assert system.server.metrics.trace.count >= req.outputs - 1   # the server's steps

        win = harness.drive(system, SEED, 1.0)
    finally:
        system.close()
    assert win.failed == 0 and any(s.done for s in win.served)
    # the model layer's shares read the cell's architecture's counts
    r = harness.Readings(cell, cell.model, cell.traffic, win, None,
                         work.PEAKS["NVIDIA H100 80GB HBM3"])
    events = list(harness.token_events(win, B))
    flops = sum(_moe_prefill_flops(cell.model, n, s.req.length) if ctx is None
                else n * _moe_decode_flops(cell.model, ctx) for _, n, ctx, _, s in events)
    mfu = harness.load_file(PKG / "metrics" / "mfu_pct.py").read(r)
    assert mfu == pytest.approx(100.0 * flops / (989e12 * win.seconds)) and mfu > 0
    mbu = harness.load_file(PKG / "metrics" / "mbu_pct.py").read(r)
    assert mbu is not None and mbu > 0
