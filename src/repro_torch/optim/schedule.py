"""LR schedules: linear-warmup cosine and WSD (warmup-stable-decay, MiniCPM).

Port of ``repro.optim.schedule``. Each schedule is a function of the step
that stays on the step's device: a CUDA step tensor gives a CUDA learning
rate with no host round trip (what a captured train step needs); a Python
int gives a CPU tensor.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def wsd(peak_lr: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup,
    long constant plateau, short exponential-ish decay tail."""
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps - stable_steps) / max(decay_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        decay = peak_lr * torch.pow(final_frac, t)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < warmup_steps + stable_steps,
                                       torch.full_like(step, peak_lr), decay))
    return lr
