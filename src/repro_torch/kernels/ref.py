"""Plain PyTorch versions of the ported kernels (port of ``repro.kernels.ref``).

These are the numerical ground truth beside each CUDA kernel: the CPU
tests run them against the reference's JAX oracles, and ``chip_smoke.py``
holds each kernel against them on the card. CPU tensors take them.

Beside each of the four kernels' plain versions sits its backward rule
(``*_bwd_ref``): the gradients of the kernel's outputs as a plain function
of tensors, which each custom op registers as its autograd formula (the
reference differentiates its plain substrate and has no backward kernels).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def _f(t: torch.Tensor) -> torch.Tensor:
    """Upcast to f32 for the math, keeping f64 as it is (f64 gradchecks)."""
    return t if t.dtype == torch.float64 else t.float()


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,        # sliding window size (keys kept per query)
    chunk: int | None = None,         # chunked-local attention
    scale: float | None = None,
    q_offset: int = 0,                # absolute position of q[0] (decode steps)
) -> torch.Tensor:
    """Reference scaled-dot-product attention with GQA broadcast."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    kf = torch.repeat_interleave(k, group, dim=2)  # (B, Sk, Hq, D)
    vf = torch.repeat_interleave(v, group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _f(q), _f(kf)) * scale

    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]   # (Sq, 1)
    kpos = torch.arange(Sk, device=q.device)[None, :]              # (1, Sk)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    if chunk is not None:
        mask &= torch.div(qpos, chunk, rounding_mode="floor") == \
            torch.div(kpos, chunk, rounding_mode="floor")
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _f(vf))
    return out.to(q.dtype)


def attention_bwd_ref(q, k, v, gout, *, causal: bool = True, window: int | None = None,
                      chunk: int | None = None, scale: float | None = None,
                      q_offset: int = 0):
    """Gradients (gq, gk, gv) of the flash-attention kernel's output.

    Recomputes the probabilities from q, k and v under the same masks as
    :func:`attention_ref` (causal, window, chunk, ``q_offset``; GQA reads kv
    head ``h // group`` in place), then the softmax backward, in f32. A
    query row with no key left (every score masked) outputs 0 in the
    kernel, so its probabilities count as 0 here and its cotangent reaches
    nothing. Plain tensor ops with no host synchronization: a backward
    through it can be captured in a CUDA graph.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = _f(q).reshape(B, Sq, Hkv, group, D)
    kf, vf = _f(k), _f(v)
    g = _f(gout).reshape(B, Sq, Hkv, group, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    if chunk is not None:
        mask &= torch.div(qpos, chunk, rounding_mode="floor") == \
            torch.div(kpos, chunk, rounding_mode="floor")
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)   # (B, Hkv, G, Sq, Sk)
    gv = torch.einsum("bhgqk,bqhgd->bkhd", p, g)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", g, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    gq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, Hq, D)
    gk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """Optional residual add, then ``x * rsqrt(mean(x²) + eps) * w`` in f32."""
    xf = _f(x)
    if residual is not None:
        xf = xf + _f(residual)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * _f(w)
    return y.to(x.dtype)


def rmsnorm_bwd_ref(x, w, gy, eps: float = 1e-6, residual=None):
    """Gradients (gx, gw, gresidual) of :func:`rmsnorm_ref`, in f32.

    With h = x (+ residual), r = rsqrt(mean(h²) + eps) and n = h·r:
    gw = Σ_rows gy·n and gh = r·(gn − n·mean(gn·n)) where gn = gy·w; the
    residual's gradient is gh, as x's is.
    """
    h = _f(x)
    if residual is not None:
        h = h + _f(residual)
    r = torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    n = h * r
    g = _f(gy)
    gw = (g * n).reshape(-1, x.shape[-1]).sum(dim=0)
    gn = g * _f(w)
    gh = r * (gn - n * torch.mean(gn * n, dim=-1, keepdim=True))
    return (gh.to(x.dtype), gw.to(w.dtype),
            None if residual is None else gh.to(residual.dtype))


# ---------------------------------------------------------------------------
# Grouped (per-expert) matmul — MoE expert GEMM
# ---------------------------------------------------------------------------

def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, d) @ (E, d, f) -> (E, C, f): f32 products, cast to x's dtype."""
    return torch.matmul(_f(x), _f(w)).to(x.dtype)


def grouped_matmul_bwd_ref(x, w, gy):
    """Gradients (gx, gw) of :func:`grouped_matmul_ref`: two batched
    products, f32 accumulation, cast to each input's dtype."""
    g = _f(gy)
    gx = torch.matmul(g, _f(w).transpose(1, 2))
    gw = torch.matmul(_f(x).transpose(1, 2), g)
    return gx.to(x.dtype), gw.to(w.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space dual)
# ---------------------------------------------------------------------------

def ssd_ref(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)      positive step sizes
    A: torch.Tensor,     # (H,)           negative decay rates
    Bm: torch.Tensor,    # (B, S, G, N)   input projections (G groups)
    Cm: torch.Tensor,    # (B, S, G, N)   output projections
    D: torch.Tensor | None = None,            # (H,) skip
    init_state: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential recurrence: h[t] = exp(dt·A) h[t-1] + dt·B[t] x[t];
    y[t] = C[t]·h[t] (+ D x[t]). Returns (y, final_state (B, H, P, N) f32).

    The reference's ``lax.scan`` is a Python loop over S steps here.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"{H} heads not a multiple of {G} groups")
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=2).float()   # (B, S, H, N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf * A.float()[None, None, :])         # (B, S, H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        dbx = torch.einsum("bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], xf[:, t])
        h = dA[:, t, :, None, None] * h + dbx
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((Bsz, 0, H, P), dtype=torch.float32, device=x.device))
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), h


def ssd_intra_chunk_ref(xs: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        lda: torch.Tensor, chunk: int):
    """Plain version of the SSD intra-chunk kernel, in its layouts.

    xs (BH, S, P) = dt·x; b, c (BG, S, N), read by head row ``bh // (BH/BG)``
    (the reference's group repeat, without the copy); lda (BH, S) = dt·A.
    S % chunk == 0. Returns y_intra (BH, S, P), state_local (BH, nc, N, P)
    and cdecay (BH, nc, 1, 1), all f32, as ``_ssd_chunk_kernel`` computes
    them per (batch·head, chunk) cell.
    """
    BH, S, P = xs.shape
    BG, N = b.shape[0], b.shape[2]
    nc, Q = S // chunk, chunk
    rep = BH // BG
    xs_c = _f(xs).reshape(BH, nc, Q, P)
    b_c = torch.repeat_interleave(_f(b), rep, dim=0).reshape(BH, nc, Q, N)
    c_c = torch.repeat_interleave(_f(c), rep, dim=0).reshape(BH, nc, Q, N)
    cums = torch.cumsum(_f(lda).reshape(BH, nc, Q), dim=2)           # inclusive
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xs.device))
    # decay(i <- j) = exp(cums[i] - cums[j]) for j <= i; selected, never
    # multiplied, so exp's overflow above the diagonal never reaches y
    L = torch.where(lower, torch.exp(cums[..., :, None] - cums[..., None, :]), 0.0)
    scores = torch.einsum("zcin,zcjn->zcij", c_c, b_c)
    y = torch.einsum("zcij,zcjp->zcip", scores * L, xs_c).reshape(BH, S, P)
    total = cums[..., -1:]                                           # (BH, nc, 1)
    decay_to_end = torch.exp(total - cums)                           # (BH, nc, Q)
    state = torch.einsum("zcjn,zcjp->zcnp", b_c * decay_to_end[..., None], xs_c)
    return y, state, total[..., None]


def ssd_intra_chunk_bwd_ref(xs, b, c, lda, chunk: int, gy, gstate, gcdecay):
    """Gradients (gxs, gb, gc, glda) of :func:`ssd_intra_chunk_ref`.

    Per (batch·head, chunk) cell, with cums the inclusive cumulative sum of
    lda, L[i, j] = exp(cums[i] − cums[j]) on and below the diagonal, S =
    C·Bᵀ, y = (S∘L)·xs, state = (B∘dte)ᵀ·xs with dte[j] = exp(total −
    cums[j]) and cdecay = total = cums[-1]. The cotangents of the three
    outputs (any may be None: a zero one) flow back through those products
    and the cumulative sum; b and c sum over the heads of their group.
    Intermediates are recomputed in f32; no host synchronization.
    """
    BH, S, P = xs.shape
    BG, N = b.shape[0], b.shape[2]
    nc, Q = S // chunk, chunk
    rep = BH // BG
    X = _f(xs).reshape(BH, nc, Q, P)
    Bc = torch.repeat_interleave(_f(b), rep, dim=0).reshape(BH, nc, Q, N)
    Cc = torch.repeat_interleave(_f(c), rep, dim=0).reshape(BH, nc, Q, N)
    cums = torch.cumsum(_f(lda).reshape(BH, nc, Q), dim=2)
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xs.device))
    L = torch.where(lower, torch.exp(cums[..., :, None] - cums[..., None, :]), 0.0)
    Sc = torch.einsum("zcin,zcjn->zcij", Cc, Bc)
    total = cums[..., -1:]
    dte = torch.exp(total - cums)                                    # (BH, nc, Q)

    gX = torch.zeros_like(X)
    gB = torch.zeros_like(Bc)
    gC = torch.zeros_like(Cc)
    gcums = torch.zeros_like(cums)
    if gy is not None:
        gY = _f(gy).reshape(BH, nc, Q, P)
        gM = torch.einsum("zcip,zcjp->zcij", gY, X)
        gX = gX + torch.einsum("zcij,zcip->zcjp", Sc * L, gY)
        gS = gM * L
        gC = gC + torch.einsum("zcij,zcjn->zcin", gS, Bc)
        gB = gB + torch.einsum("zcij,zcin->zcjn", gS, Cc)
        T = gM * Sc * L                                              # ∂/∂cums via L
        gcums = gcums + T.sum(dim=-1) - T.sum(dim=-2)
    gtotal = torch.zeros_like(total)
    if gstate is not None:
        gSt = _f(gstate)                                             # (BH, nc, N, P)
        Bw = Bc * dte[..., None]
        gX = gX + torch.einsum("zcjn,zcnp->zcjp", Bw, gSt)
        gBw = torch.einsum("zcjp,zcnp->zcjn", X, gSt)
        gB = gB + gBw * dte[..., None]
        gdte = (gBw * Bc).sum(dim=-1) * dte                          # (BH, nc, Q)
        gtotal = gtotal + gdte.sum(dim=-1, keepdim=True)
        gcums = gcums - gdte
    if gcdecay is not None:
        gtotal = gtotal + _f(gcdecay).reshape(BH, nc, 1)
    gcums = torch.cat([gcums[..., :-1], gcums[..., -1:] + gtotal], dim=-1)
    glda = torch.flip(torch.cumsum(torch.flip(gcums, [-1]), dim=-1), [-1])
    gb = gB.reshape(BG, rep, S, N).sum(dim=1)
    gc = gC.reshape(BG, rep, S, N).sum(dim=1)
    return (gX.reshape(BH, S, P).to(xs.dtype), gb.to(b.dtype), gc.to(c.dtype),
            glda.reshape(BH, S).to(lda.dtype))


def pad_ragged(chunk: int, x, dt, Bm, Cm):
    """Pad S up to a multiple of ``chunk`` with dt = 0 steps (dA = 1 and
    dt·B·x = 0), which leave the state and the real positions' outputs
    unchanged."""
    pad = -x.shape[1] % chunk
    if not pad:
        return x, dt, Bm, Cm

    def p(t):
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    return p(x), p(dt), p(Bm), p(Cm)


def ssd_chunked_ref(x, dt, A, Bm, Cm, D=None, init_state=None, chunk: int = 64):
    """Chunked (SSD) form of the same recurrence in plain torch: the
    blockwise algorithm of the kernel; matches :func:`ssd_ref`. A ragged S
    is padded with dt = 0 steps (:func:`pad_ragged`)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        xp, dtp, Bp, Cp = pad_ragged(chunk, x, dt, Bm, Cm)
        y, hT = ssd_chunked_ref(xp, dtp, A, Bp, Cp, D=D, init_state=init_state,
                                chunk=chunk)
        return y[:, :S], hT
    nc, Q = S // chunk, chunk
    rep = H // G

    Bh = torch.repeat_interleave(Bm, rep, dim=2).float()
    Ch = torch.repeat_interleave(Cm, rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    lda = dtf * A.float()[None, None, :]              # log dA  (B, S, H)
    xs = xf * dtf[..., None]                          # dt * x

    lda_c = lda.reshape(Bsz, nc, Q, H)
    xs_c = xs.reshape(Bsz, nc, Q, H, P)
    b_c = Bh.reshape(Bsz, nc, Q, H, N)
    c_c = Ch.reshape(Bsz, nc, Q, H, N)

    cums = torch.cumsum(lda_c, dim=2)                 # (B, nc, Q, H)
    decay = torch.exp(cums[:, :, :, None] - cums[:, :, None, :, :])  # (B,nc,Qi,Qj,H)
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.where(lower[None, None, :, :, None], decay, 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", c_c, b_c)
    y_intra = torch.einsum("bcijh,bcijh,bcjhp->bcihp", scores, L, xs_c)

    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)   # (B, nc, Q, H)
    state_local = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", b_c, decay_to_end, xs_c)

    chunk_decay = torch.exp(cums[:, :, -1, :])            # (B, nc, H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, ci, :, None, None] * h + state_local[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)                  # (B, nc, H, P, N)
    y_inter = torch.einsum("bcihn,bchpn,bcih->bcihp", c_c, h_prev, torch.exp(cums))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), h
