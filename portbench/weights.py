"""Seeded weights of a dense decoder, made on the device in a few large calls.

Every tensor is a view into one float32 buffer. Tensors that share a
distribution sit next to each other, so the whole buffer takes one
``normal_`` from a generator on the device and one clamp and one scale per
group: matrices are normals truncated at two standard deviations with the
standard deviation fan_in^-1/2; biases normals of 0.02; norm scales 1 plus
normals of 0.1 (so a norm that drops its scale reads wrong). The keys are
the names the program's parameter tree uses, which the reference reads too.
"""
from __future__ import annotations

import math

import torch

#: Offsets into the buffer are multiples of this many values (256 bytes).
ALIGN = 64


def layout(model: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, group) of every tensor; group names the distribution."""
    d, H, Hkv = model["d_model"], model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    f, V = model["d_ff"], model["padded_vocab"]
    out = [("embed.table", (V, d), f"w{d}"), ("head.table", (V, d), f"w{d}"),
           ("final_norm.scale", (d,), "norm")]
    for i in range(model["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), "norm"), (p + "norm2.scale", (d,), "norm"),
                (p + "attn.wq.w", (d, H * hd), f"w{d}"),
                (p + "attn.wk.w", (d, Hkv * hd), f"w{d}"),
                (p + "attn.wv.w", (d, Hkv * hd), f"w{d}"),
                (p + "attn.wo.w", (H * hd, d), f"w{H * hd}"),
                (p + "mlp.up.w", (d, f), f"w{d}"),
                (p + "mlp.down.w", (f, d), f"w{f}")]
        if model["mlp"] == "swiglu":
            out.append((p + "mlp.gate.w", (d, f), f"w{d}"))
        if model["qkv_bias"]:
            out += [(p + "attn.wq.b", (H * hd,), "bias"), (p + "attn.wk.b", (Hkv * hd,), "bias"),
                    (p + "attn.wv.b", (Hkv * hd,), "bias")]
    return out


def _pad(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _plan(model: dict):
    """(offset, name, shape) of every tensor and (start, end) of every group."""
    at, placed, spans = 0, [], {}
    for name, shape, group in sorted(layout(model), key=lambda it: it[2]):
        n = _pad(math.prod(shape))
        placed.append((at, name, shape))
        spans[group] = (spans.get(group, (at, at))[0], at + n)
        at += n
    return at, placed, spans


def fill(buf: torch.Tensor, model: dict, seed: int) -> None:
    """Draw every tensor of ``buf`` from ``seed``, in place."""
    gen = torch.Generator(device=buf.device).manual_seed(seed % (1 << 63))
    buf.normal_(generator=gen)
    for group, (lo, hi) in _plan(model)[2].items():
        part = buf[lo:hi]
        if group == "norm":
            part.mul_(0.1).add_(1.0)
        elif group == "bias":
            part.mul_(0.02)
        else:
            part.clamp_(-2.0, 2.0).mul_(int(group[1:]) ** -0.5)


def make(model: dict, seed: int, device: torch.device | str) -> tuple[dict, torch.Tensor]:
    """({name: view}, the buffer) drawn from ``seed`` on ``device``."""
    total, placed, _ = _plan(model)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    fill(buf, model, seed)
    weights = {name: buf[at:at + math.prod(shape)].view(shape) for at, name, shape in placed}
    return weights, buf
