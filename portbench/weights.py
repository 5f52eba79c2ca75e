"""Seeded weights of a configuration, made on the device in a few large calls.

The tensors are those the configuration's architecture module lays out
(``arch/<name>.py``: ``layout(model)``, (name, shape, group) of each).
Every tensor is a view into one float32 buffer. Tensors that share a
distribution sit next to each other, so the whole buffer takes one
``normal_`` from a generator on the device and one clamp and one scale per
group: matrices are normals truncated at two standard deviations with the
standard deviation fan_in^-1/2; biases normals of 0.02; norm scales 1 plus
normals of 0.1 (so a norm that drops its scale reads wrong). The keys are
the names the program's parameter tree uses, which the reference reads too.
The same layout and seed give the same buffer, bit for bit.
"""
from __future__ import annotations

import math

import torch

#: Offsets into the buffer are multiples of this many values (256 bytes).
ALIGN = 64


def _pad(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _plan(layout: list[tuple[str, tuple, str]]):
    """(total length, [(offset, name, shape) of every tensor], {group: (start, end)})."""
    at, placed, spans = 0, [], {}
    for name, shape, group in sorted(layout, key=lambda it: it[2]):
        n = _pad(math.prod(shape))
        placed.append((at, name, shape))
        spans[group] = (spans.get(group, (at, at))[0], at + n)
        at += n
    return at, placed, spans


def fill(buf: torch.Tensor, layout: list, seed: int) -> None:
    """Draw every tensor of ``layout`` in ``buf`` from ``seed``, in place."""
    gen = torch.Generator(device=buf.device).manual_seed(seed % (1 << 63))
    buf.normal_(generator=gen)
    for group, (lo, hi) in _plan(layout)[2].items():
        part = buf[lo:hi]
        if group == "norm":
            part.mul_(0.1).add_(1.0)
        elif group == "bias":
            part.mul_(0.02)
        else:
            part.clamp_(-2.0, 2.0).mul_(int(group[1:]) ** -0.5)


def make(layout: list, seed: int, device: torch.device | str) -> tuple[dict, torch.Tensor]:
    """({name: view}, the buffer) of ``layout`` drawn from ``seed`` on ``device``."""
    total, placed, _ = _plan(layout)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    fill(buf, layout, seed)
    weights = {name: buf[at:at + math.prod(shape)].view(shape) for at, name, shape in placed}
    return weights, buf
