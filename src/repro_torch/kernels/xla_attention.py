"""Memory-bounded plain attention (port of ``repro.kernels.xla_attention``).

``ref.attention_ref`` materializes (B, H, Sq, Sk) scores and repeats the KV
heads: fine for tests, not at long sequences. These keep its numerics (f32
scores and softmax, -1e30 masks) but bound memory and, for the local
patterns, the work:

* ``sdpa_full``    — a loop over query chunks: O(S·chunk) live scores.
* ``sdpa_sliding`` — block-banded: each w-block of queries attends its own
                     and the previous key block: O(S·2w).
* ``sdpa_chunked`` — block-diagonal (chunked-local): O(S·c).
* ``sdpa_cross``   — non-causal (encoder / cross) attention.

All use grouped-GQA einsums (queries as (B, S, Hkv, G, D); no KV repeat).
These are the plain versions the ``ref`` substrate of ``ops.attention``
runs; ``ref.attention_ref`` stays the oracle.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _group(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,D), (B,S,Hkv,D) -> q as (B,S,Hkv,G,D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    return q.reshape(B, S, Hkv, Hq // Hkv, D)


def _softmax_pv(s: torch.Tensor, vf: torch.Tensor, pattern: str) -> torch.Tensor:
    return torch.einsum(pattern, torch.softmax(s, dim=-1), vf)


def sdpa_full(q, k, v, *, causal: bool = True, scale: float | None = None,
              q_offset: int = 0, chunk: int = 2048) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    scale = (D ** -0.5) if scale is None else scale
    qg = _group(q, k).float()
    kf, vf = k.float(), v.float()
    chunk = min(chunk, Sq)
    if Sq % chunk != 0:
        return _sdpa_full_once(qg, kf, vf, causal, scale, q_offset, 0, Sq).to(q.dtype)
    outs = [_sdpa_full_once(qg[:, i * chunk:(i + 1) * chunk], kf, vf, causal, scale,
                            q_offset, i * chunk, chunk) for i in range(Sq // chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, D).to(q.dtype)


def _sdpa_full_once(qg, kf, vf, causal, scale, q_offset, chunk_start, chunk_len):
    Sk = kf.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    if causal:
        qpos = q_offset + chunk_start + torch.arange(chunk_len, device=qg.device)[:, None]
        kpos = torch.arange(Sk, device=qg.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG)
    out = _softmax_pv(s, vf, "bhgqk,bkhd->bqhgd")
    return out.reshape(out.shape[:2] + (-1, out.shape[-1]))


def sdpa_sliding(q, k, v, *, window: int, scale: float | None = None) -> torch.Tensor:
    """Causal sliding-window attention, block-banded (exact O(S·2w))."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = (D ** -0.5) if scale is None else scale
    w = window
    if S % w != 0 or S <= w:
        return _sdpa_masked_small(q, k, v, scale, window=w)
    nb = S // w
    qg = _group(q, k).float().reshape(B, nb, w, Hkv, Hq // Hkv, D)
    kb = k.float().reshape(B, nb, w, Hkv, D)
    vb = v.float().reshape(B, nb, w, Hkv, D)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)                  # (B, nb, 2w, Hkv, D)
    v2 = torch.cat([vprev, vb], dim=2)

    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", qg, k2) * scale
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None] + w     # within the 2w frame
    kpos = torch.arange(2 * w, device=dev)[None, :]
    base = (qpos >= kpos) & ((qpos - kpos) < w)         # (w, 2w)
    first = base & (kpos >= w)                          # block 0 has no prev
    mask = torch.where((torch.arange(nb, device=dev) == 0)[:, None, None],
                       first[None], base[None])         # (nb, w, 2w)
    s = torch.where(mask[None, :, None, None], s, NEG)
    out = _softmax_pv(s, v2, "bnhgqk,bnkhd->bnqhgd")
    return out.reshape(B, S, Hq, D).to(q.dtype)


def sdpa_chunked(q, k, v, *, chunk: int, scale: float | None = None) -> torch.Tensor:
    """Causal block-diagonal (chunked-local) attention: exact O(S·c)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = (D ** -0.5) if scale is None else scale
    c = chunk
    if S % c != 0 or S <= c:
        return _sdpa_masked_small(q, k, v, scale, chunk=c)
    nb = S // c
    qg = _group(q, k).float().reshape(B, nb, c, Hkv, Hq // Hkv, D)
    kb = k.float().reshape(B, nb, c, Hkv, D)
    vb = v.float().reshape(B, nb, c, Hkv, D)
    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", qg, kb) * scale
    i = torch.arange(c, device=q.device)
    s = torch.where(i[:, None] >= i[None, :], s, NEG)
    out = _softmax_pv(s, vb, "bnhgqk,bnkhd->bnqhgd")
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _sdpa_masked_small(q, k, v, scale, window: int | None = None,
                       chunk: int | None = None):
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    qg = _group(q, k).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    if chunk:
        mask &= (qpos // chunk) == (kpos // chunk)
    s = torch.where(mask, s, NEG)
    out = _softmax_pv(s, v.float(), "bhgqk,bkhd->bqhgd")
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def sdpa_cross(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """Non-causal (encoder / cross) attention, grouped-GQA."""
    B, Sq, Hq, D = q.shape
    scale = (D ** -0.5) if scale is None else scale
    qg = _group(q, k).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    out = _softmax_pv(s, v.float(), "bhgqk,bkhd->bqhgd")
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
