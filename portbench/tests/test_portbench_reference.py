"""The frozen reference against the program's model at a reduced size: the
same seeded weights and tokens, prefill and then decode through the cache,
both in float32. And the control's float8 rounding against the exact path."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench import weights as W
from portbench.arch import dense

PKG = Path(__file__).resolve().parents[1]
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
             d_ff=256, vocab_size=700, dtype="float32")


def _reference(name):
    spec = importlib.util.spec_from_file_location("ref_" + name, PKG / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(config):
    conf = json.loads((PKG / "configs" / f"{config}.json").read_text())
    m = dict(conf["model"], **SMALL)
    m["padded_vocab"] = -(-m["vocab_size"] // 256) * 256
    return conf, m


@pytest.mark.parametrize("config", ["glm4-9b", "minitron-8b"])
def test_reference_is_the_programs_model(config):
    from portbench.harness import port_config
    from repro_torch.models import model as M

    conf, m = _small(config)
    cfg = port_config(m)
    weights, _ = W.make(dense.layout(m), 11, "cpu")
    port = M.model_of(cfg, weights)
    ref = _reference(conf["reference"])
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(2, m["vocab_size"], (2, 24), generator=g, dtype=torch.int32)
    prompt = 15
    with torch.no_grad():
        logits, caches, pos = M.prefill(port, cfg, {"tokens": toks[:, :prompt]}, 32)
        got = [logits[:, -1, :m["vocab_size"]]]
        for j in range(prompt, toks.shape[1] - 1):
            lg, caches = M.decode_step(port, cfg, toks[:, j:j + 1], pos, caches)
            pos = pos + 1
            got.append(lg[:, -1, :m["vocab_size"]])
    got = torch.stack(got, 1)
    for b in range(2):
        want = ref.logits_at(m, weights, toks[b, :-1].long(),
                             torch.arange(prompt - 1, toks.shape[1] - 1))
        torch.testing.assert_close(got[b], want, atol=1e-4, rtol=1e-4)


def test_weights_are_the_seeds():
    _, m = _small("glm4-9b")
    a, buf = W.make(dense.layout(m), 2**31 + 9, "cpu")
    b, _ = W.make(dense.layout(m), 2**31 + 9, "cpu")
    c, _ = W.make(dense.layout(m), 2**31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.table"], c["head.table"])
    assert sorted(a) == sorted(name for name, _, _ in dense.layout(m))
    assert all((t.data_ptr() - buf.data_ptr()) % 256 == 0 for t in a.values())
    assert a["layers.0.attn.wq.w"].abs().max() <= 2 * 128 ** -0.5 + 1e-6


def test_control_rounds_to_float8():
    conf, m = _small("glm4-9b")
    ref = _reference(conf["reference"])
    weights, _ = W.make(dense.layout(m), 4, "cpu")
    toks = torch.randint(2, m["vocab_size"], (20,), generator=torch.Generator().manual_seed(2))
    rows = torch.arange(20)
    exact = ref.logits_at(m, weights, toks, rows)
    low = ref.logits_at(m, weights, toks, rows, quant="fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.3
    x = torch.randn(64, 32)
    q = ref._fp8(x, -1)
    assert ((q - x).abs() / x.abs().amax(-1, keepdim=True)).max() < 2 ** -3
