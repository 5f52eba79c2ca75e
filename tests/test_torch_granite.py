"""Granite 4.0-H in the port, held to the plain reference at a small size.

``granite-4.0-h-small`` has no JAX counterpart, so the port is held to the
benchmark's plain float32 reference (``portbench/reference/granitemoehybrid.py``,
loaded from its file) on the same seeded weights: a tiny model of four layers
(Mamba, attention, Mamba, Mamba), 8 experts, top-2, experts 0–3 held, a
shared expert of its own width, NoPE attention scaled by 1 / head_dim, in
float32. Prefill and then decoding through both kinds of state, eagerly and
served through ``RegionServer``'s vmapped step, agree with the reference's
full forward pass on logits; the two shares of the experts add up to the
uncut layer; dropless routing keeps every (token, choice); the attention
scale and NoPE are the reference's.

Tolerances. Logits at atol = rtol = 1e-4: both sides compute in float32,
but in other orders (the program blocks the SSD in chunks of 8 and the
reference in 16, the program's dispatch sums a token's choices after the
grouped products, its norms are the kernels' plain versions), which moves
logits of up to 0.5 by ~1e-7; the same model in bfloat16 misses by ~1e-3.
Layer outputs that add the same products in another grouping, at 1e-5.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import TDG
from repro_torch.core.lower import clear_intern_cache
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving import RegionServer

REF = Path(__file__).resolve().parents[1] / "portbench" / "reference" / "granitemoehybrid.py"
MAX_LEN = 40
TOL = dict(atol=1e-4, rtol=1e-4)

TINY = ModelConfig(
    name="granite-tiny", family="hybrid", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
    layer_types=("mamba", "attention", "mamba", "mamba"), attn_scale=1 / 16, rope_theta=0.0,
    num_experts=8, top_k=2, moe_d_ff=32, num_shared_experts=1, shared_d_ff=48,
    experts_held=4, expert_offset=0, capacity_factor=8 / 2, ssm_state=16, ssm_headdim=16,
    ssm_expand=2, ssm_groups=1, ssm_conv=4, ssm_chunk=8, tie_embeddings=True,
    embed_scale=12.0, residual_scale=0.22, logit_scale=1 / 16, dtype="float32")


def _reference():
    spec = importlib.util.spec_from_file_location("granite_reference", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_block(cfg: ModelConfig) -> dict:
    """The configuration's ``model`` block as the reference reads it."""
    m = dataclasses.asdict(cfg)
    m.update(norm_eps=1e-6, mamba_chunk_size=16, padded_vocab=cfg.padded_vocab)
    return m


def _params(cfg: ModelConfig, seed: int = 3) -> M.Model:
    """Seeded weights, with the norms, biases and SSM constants drawn too
    (their init values, ones and zeros, would hide a missing term)."""
    gen = torch.Generator().manual_seed(seed)
    model = M.init_params(cfg, gen)
    for name, p in model.named_parameters():
        if name.endswith(("scale", "D")):
            p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))
        elif name.endswith((".b", "A_log", "dt_bias")):
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return model


def _tokens(seed: int, n: int) -> torch.Tensor:
    return torch.randint(2, TINY.vocab_size, (n,), generator=torch.Generator().manual_seed(seed))


def _want(ref, params, toks: torch.Tensor, first: int) -> torch.Tensor:
    """The reference's logits at positions first-1 .. len-2 (the tokens that
    predicted toks[first:])."""
    weights = M.params_of(params)
    return ref.logits_at(_model_block(TINY), weights, toks[:-1],
                         torch.arange(first - 1, toks.numel() - 1))


def test_configuration_and_counts():
    cfg = configs.get_config("granite-4.0-h-small")
    assert "granite-4.0-h-small" in configs.archs() and cfg.name not in configs.ARCHS
    assert [i for i in range(40) if cfg.layer_kind(i) == "attention"] == [5, 15, 25, 35]
    assert (cfg.held_experts, cfg.shared_expert_d_ff, cfg.ssm_heads) == (9, 1536, 128)
    tree = M.Model(cfg, "meta")
    assert M.param_count(tree) == 8_425_634_304
    # the counts follow the kinds: the tree less the norms, one of the SSM's
    # three per-head constants (the reference's ssm_params counts two) and
    # the conv bias
    small = 36 * (2 * 4096 + 128 + 8192 + 8448) + 4 * 2 * 4096 + 4096
    assert cfg.param_count() == M.param_count(tree) - small
    assert tree.layers[5].attn.wq.w.shape == (4096, 4096) and not hasattr(tree.layers[5], "ssm")
    assert tree.layers[0].moe.experts.up.w.shape == (9, 4096, 768)
    assert tree.layers[0].moe.router.w.shape == (4096, 72)
    assert cfg.active_param_count() < cfg.param_count()
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(TINY, layer_types=("mamba",) * 3)
    with pytest.raises(ValueError, match="held of 8"):
        dataclasses.replace(TINY, expert_offset=6)


def test_prefill_then_decode_agree_with_the_reference():
    ref, params = _reference(), _params(TINY)
    toks = _tokens(1, 21)
    prompt = 13                        # not a whole number of the SSD's chunks
    with torch.no_grad():
        logits, caches, pos = M.prefill(params, TINY, {"tokens": toks[None, :prompt]}, MAX_LEN)
        assert [set(c) for c in caches] == [{"ssm"}, {"attn"}, {"ssm"}, {"ssm"}]
        got = [logits[0, -1]]
        for j in range(prompt, toks.numel() - 1):
            lg, caches = M.decode_step(params, TINY, toks[None, j:j + 1], pos, caches)
            pos = pos + 1
            got.append(lg[0, -1])
    torch.testing.assert_close(torch.stack(got), _want(ref, params, toks, prompt), **TOL)


def test_served_decode_agrees_with_the_reference():
    """Three tenants' decode steps through the server's coalesced, vmapped
    replay: each step's logits are the reference's at that position."""
    ref, params = _reference(), _params(TINY, seed=4)
    clear_intern_cache()

    def step(params, tokens, pos, caches):
        logits, caches = M.decode_step(params, TINY, tokens, pos, caches)
        return logits[:, -1], caches

    server = RegionServer(max_batch=4, max_wait_ms=0, autostart=False)
    for i in range(3):
        g = TDG(f"decode[{i}]")
        g.add_task(step, ins=["params", "tokens", "pos", "caches"], outs=["logits", "caches"],
                   name="decode")
        server.register_tenant(f"t{i}", g, outputs=("logits", "caches"))
    server.start()
    try:
        seqs, states = [], []
        for i in range(3):
            toks, prompt = _tokens(10 + i, 24), 9 + 2 * i
            with torch.no_grad():
                _, caches, pos = M.prefill(params, TINY, {"tokens": toks[None, :prompt]},
                                           MAX_LEN)
            seqs.append((toks, prompt))
            states.append([caches, pos, []])
        for k in range(5):
            futs = []
            for i, (toks, prompt) in enumerate(seqs):
                caches, pos, _ = states[i]
                tok = toks[None, prompt + k:prompt + k + 1].to(torch.int32)
                futs.append(server.submit(f"t{i}", {"params": params, "tokens": tok,
                                                    "pos": pos, "caches": caches}))
            for i, f in enumerate(futs):
                out = f.result(timeout=120)
                states[i][0], states[i][1] = out["caches"], states[i][1] + 1
                states[i][2].append(out["logits"][0])
    finally:
        server.close()
    for (toks, prompt), (_, _, got) in zip(seqs, states):
        want = _want(ref, params, toks[:prompt + 6], prompt + 1)
        torch.testing.assert_close(torch.stack(got), want, **TOL)
    m = server.stats()["metrics"]
    assert m["batch_fallbacks"] == 0 and m["batch_occupancy_max"] == 3


def _layer(cfg: ModelConfig, whole: MOE.MoE) -> MOE.MoE:
    """``cfg``'s MoE layer holding its share of ``whole``'s experts."""
    lo, n = cfg.expert_offset, cfg.held_experts
    part = MOE.MoE(cfg, "cpu")
    for name, p in part.named_parameters():
        src = dict(whole.named_parameters())[name]
        p.copy_(src[lo:lo + n] if name.startswith("experts.") else src)
    return part


def test_the_shares_add_up_to_the_uncut_layer():
    uncut = dataclasses.replace(TINY, experts_held=0)
    whole = MOE.MoE(uncut, "cpu")
    gen = torch.Generator().manual_seed(7)
    for mod in whole.modules():
        if hasattr(mod, "init_"):
            mod.init_(gen)
    x = torch.randn(2, 11, TINY.d_model, generator=gen)
    with torch.no_grad():
        full, _ = MOE.moe_apply(whole, uncut, x)
        shares = [MOE.moe_apply(_layer(dataclasses.replace(TINY, expert_offset=lo), whole),
                                dataclasses.replace(TINY, expert_offset=lo), x)[0]
                  for lo in (0, 4)]
        shared = MOE._shared_experts(whole, uncut, x, torch.zeros_like(x))
    # the shared expert, which every chip computes alike, counted once
    torch.testing.assert_close(shares[0] + shares[1] - shared, full, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(shares[0], full, atol=1e-3)


@pytest.mark.parametrize("tokens", [1, 3, 8, 17, 64, 130])
def test_dropless_routing_keeps_every_choice(tokens):
    """Every (token, choice) has its row, however the router piles them up:
    here every token's first choice is expert 0; the layer then equals the
    per-token sum over its held choices. The other families' capacity
    factor, 1.25, drops choices on the same routing."""
    cfg = dataclasses.replace(TINY, experts_held=0)
    layer = MOE.MoE(cfg, "cpu")
    gen = torch.Generator().manual_seed(tokens)
    for mod in layer.modules():
        if hasattr(mod, "init_"):
            mod.init_(gen)
    layer.router.w[:, 0] += 5.0                        # every token's favourite
    x = torch.rand(1, tokens, cfg.d_model, generator=gen) + 0.5
    flat = MOE.route(layer, cfg, x[0])[2].reshape(-1)
    keep = MOE._positions(flat, cfg.num_experts, MOE.capacity(cfg, tokens))[1]
    assert bool(keep.all())
    capped = dataclasses.replace(cfg, capacity_factor=1.25)
    if tokens >= 64:
        kept = MOE._positions(flat, cfg.num_experts, MOE.capacity(capped, tokens))[1]
        assert not bool(kept.all())
    with torch.no_grad():
        out, _ = MOE.moe_apply(layer, cfg, x)
        _, gates, idx = MOE.route(layer, cfg, x[0])
        want = MOE._shared_experts(layer, cfg, x, torch.zeros_like(x))[0]
        ex = layer.experts
        for t in range(tokens):
            for k in range(cfg.top_k):
                e = int(idx[t, k])
                h = torch.nn.functional.silu(x[0, t] @ ex.gate.w[e]) * (x[0, t] @ ex.up.w[e])
                want[t] += gates[t, k] * (h @ ex.down.w[e])
    torch.testing.assert_close(out[0], want, atol=1e-5, rtol=1e-5)


def test_attention_scale_and_nope_are_the_references():
    """An attention layer of the tiny model, prefilled and then decoded
    through its ring, against the reference's attention: scores scaled by
    ``attn_scale`` (1/16 here, not 16 ** -0.5), and no rotation."""
    ref, params = _reference(), _params(TINY, seed=9)
    block = params.layers[1]
    gen = torch.Generator().manual_seed(2)
    h = torch.randn(1, 12, TINY.d_model, generator=gen)
    pos = torch.arange(12, dtype=torch.int32)[None]
    weights = {k: v for k, v in M.params_of(params).items()}
    want = ref._attention(h[0], weights, "layers.1.attn.", _model_block(TINY), None, 5)
    with torch.no_grad():
        got, _ = L.attention_apply(block.attn, TINY, h, pos)
        torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)
        cache = L.init_attn_cache(TINY, 1, 1, MAX_LEN)
        stepped = []
        for t in range(12):
            out, cache = L.attention_apply(block.attn, TINY, h[:, t:t + 1], pos[:, t:t + 1],
                                           cache=cache)
            stepped.append(out[0, 0])
    torch.testing.assert_close(torch.stack(stepped), want, atol=1e-5, rtol=1e-5)
    # the scale is not the default, and NoPE: the output ignores the positions
    with torch.no_grad():
        default, _ = L.attention_apply(block.attn, dataclasses.replace(TINY, attn_scale=0.0),
                                       h, pos)
        moved, _ = L.attention_apply(block.attn, TINY, h, pos + 100)
    assert not torch.allclose(default, got, atol=1e-4)
    torch.testing.assert_close(moved, got, atol=0, rtol=0)
