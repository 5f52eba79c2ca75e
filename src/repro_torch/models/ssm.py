"""Mamba-2 mixer (SSD): the sequence path through the chunked SSD (the CUDA
intra-chunk kernel on the card), the decode path through the O(1)
single-step recurrence on a carried state.

Port of ``repro.models.ssm``: in_proj -> [z | xBC | dt]; causal conv over
xBC; SSD over heads; gated RMSNorm; out_proj. With ``ssm_split_proj`` the
projections are separate (``z_proj``, ``x_proj``, ``b_proj``, ``c_proj``,
``dt_proj``) and so are the depthwise convs (``xconv``, ``bconv``,
``cconv``), whose histories make one conv state, concatenated in that
order: the same function as the fused layout with its weights split.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from . import layers as L


def ssm_dims(cfg: ModelConfig) -> dict:
    di = cfg.ssm_inner
    H = cfg.ssm_heads
    G, N, K = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    conv_ch = di + 2 * G * N
    return dict(d_inner=di, heads=H, P=cfg.ssm_headdim, groups=G, N=N,
                K=K, conv_ch=conv_ch, in_dim=2 * di + 2 * G * N + H)


class CausalConv(nn.Module):
    """Depthwise causal conv1d: ``w`` (K, channels), ``b`` (channels)."""

    def __init__(self, K: int, channels: int, dtype, device=None):
        super().__init__()
        self.w = L._param(K, channels, dtype=dtype, device=device)
        self.b = L._param(channels, dtype=dtype, device=device, fill=0.0)

    def init_(self, generator: torch.Generator) -> None:
        L.init_dense_(self.w, self.w.shape[0], generator)


class SSM(nn.Module):
    """``A_log = 0`` (A = -1), ``D = 1`` and ``dt_bias = -2`` (softplus ≈ 0.12)
    at init, as in the reference; ``in_proj`` and ``conv`` (or the split
    projections and convs), ``norm`` and ``out_proj`` under the reference's
    names."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dd = ssm_dims(cfg)
        dt = cfg.param_torch_dtype
        H = dd["heads"]
        self.A_log = L._param(H, dtype=dt, device=device, fill=0.0)
        self.D = L._param(H, dtype=dt, device=device, fill=1.0)
        self.dt_bias = L._param(H, dtype=dt, device=device, fill=-2.0)
        self.norm = L.RMSNorm(dd["d_inner"], dt, device)
        self.out_proj = L.Linear(dd["d_inner"], cfg.d_model, dtype=dt, device=device)
        if cfg.ssm_split_proj:
            dm, di, gn = cfg.d_model, dd["d_inner"], dd["groups"] * dd["N"]
            for name, width in (("z", di), ("x", di), ("b", gn), ("c", gn), ("dt", H)):
                setattr(self, f"{name}_proj", L.Linear(dm, width, dtype=dt, device=device))
            for name, width in (("x", di), ("b", gn), ("c", gn)):
                setattr(self, f"{name}conv", CausalConv(dd["K"], width, dt, device))
        else:
            self.in_proj = L.Linear(cfg.d_model, dd["in_dim"], dtype=dt, device=device)
            self.conv = CausalConv(dd["K"], dd["conv_ch"], dt, device)


def _split_in(cfg: ModelConfig, proj: torch.Tensor):
    dd = ssm_dims(cfg)
    di, gn = dd["d_inner"], dd["groups"] * dd["N"]
    return proj[..., :di], proj[..., di:2 * di + 2 * gn], proj[..., 2 * di + 2 * gn:]


def _causal_conv(p: CausalConv, xBC: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv1d + silu. state: (B, K-1, C) history."""
    K, C = p.w.shape
    Bz, S, _ = xBC.shape
    hist = (torch.zeros((Bz, K - 1, C), dtype=xBC.dtype, device=xBC.device)
            if state is None else state.to(xBC.dtype))
    full = torch.cat([hist, xBC], dim=1)                       # (B, S+K-1, C)
    out = torch.zeros((Bz, S, C), dtype=torch.float32, device=xBC.device)
    for k in range(K):
        out = out + full[:, k:k + S].float() * p.w[k].float()
    out = out + p.b.float()
    new_state = full[:, S:] if K > 1 else full[:, :0]          # the last K-1 steps
    return F.silu(out).to(xBC.dtype), new_state


def ssm_apply(p: SSM, cfg: ModelConfig, x: torch.Tensor,
              state: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, d_model). state: {"conv": (B, K-1, C), "ssd": (B, H, P, N)}."""
    Bz, S, _ = x.shape
    dd = ssm_dims(cfg)
    H, Pd, G, N, di = dd["heads"], dd["P"], dd["groups"], dd["N"], dd["d_inner"]
    cdt = cfg.compute_dtype

    conv_state = state["conv"] if state is not None else None
    if cfg.ssm_split_proj:
        z = L.linear(p.z_proj, x, cdt)
        dt_raw = L.linear(p.dt_proj, x, cdt)
        cuts = (0, di, di + G * N, di + 2 * G * N)
        outs, hists = [], []
        for name, lo, hi in zip("xbc", cuts, cuts[1:]):
            part = L.linear(getattr(p, f"{name}_proj"), x, cdt)
            part, hist = _causal_conv(getattr(p, f"{name}conv"), part,
                                      None if conv_state is None else conv_state[..., lo:hi])
            outs.append(part)
            hists.append(hist)
        new_conv = torch.cat(hists, dim=-1)
        xr, br, cr = outs
    else:
        proj = L.linear(p.in_proj, x, cdt)
        z, xBC, dt_raw = _split_in(cfg, proj)
        xBC, new_conv = _causal_conv(p.conv, xBC, conv_state)
        xr, br, cr = xBC[..., :di], xBC[..., di:di + G * N], xBC[..., di + G * N:]
    xin = xr.reshape(Bz, S, H, Pd)
    Bm = br.reshape(Bz, S, G, N)
    Cm = cr.reshape(Bz, S, G, N)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())       # (B, S, H)
    A = -torch.exp(p.A_log.float())

    init = state["ssd"] if state is not None else None
    if S == 1 and state is not None:
        # decode: single-step recurrence, no scan
        dA = torch.exp(dt[:, 0, :] * A[None, :])                          # (B, H)
        Brep = torch.repeat_interleave(Bm[:, 0], H // G, dim=1).float()   # (B, H, N)
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dt[:, 0], Brep, xin[:, 0].float())
        h = dA[:, :, None, None] * init.float() + dBx
        Crep = torch.repeat_interleave(Cm[:, 0], H // G, dim=1).float()
        y = torch.einsum("bhpn,bhn->bhp", h, Crep)
        y = y + p.D.float()[None, :, None] * xin[:, 0].float()
        y = y.reshape(Bz, 1, di).to(cdt)
        new_ssd = h
    else:
        y, new_ssd = ops.ssd(xin, dt.to(cdt), A, Bm.to(cdt), Cm.to(cdt),
                             D=p.D.float(), init_state=init, chunk=cfg.ssm_chunk)
        y = y.reshape(Bz, S, di).to(cdt)

    # gated norm + out projection
    y = y.float() * F.silu(z.float())
    y = L.rmsnorm(p.norm, y.to(cdt))
    out = L.linear(p.out_proj, y, cdt)
    new_state = ({"conv": new_conv, "ssd": new_ssd.float()}
                 if state is not None else None)
    return out, new_state


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    dd = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, dd["K"] - 1, dd["conv_ch"]), dtype=cfg.compute_dtype,
                            device=device),
        "ssd": torch.zeros((batch, dd["heads"], dd["P"], dd["N"]), dtype=torch.float32,
                           device=device),
    }
