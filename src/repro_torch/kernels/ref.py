"""Plain PyTorch versions of the kernels (quadratic attention and its
flash-backward equations, sequential scan).

Port of ``repro/kernels/ref.py``.  The CPU path of ``ops`` runs these, and the
card's checks hold each kernel against them on the same inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30


def _masked_scores(q, k, scale, causal, window):
    """fp32 scaled scores ``[B,H,Tq,Tk]`` against k repeated over each GQA
    group (masked entries -1e30) and the mask ``[Tq,Tk]`` (True = kept)."""
    H, K = q.shape[2], k.shape[2]
    if K != H:
        k = torch.repeat_interleave(k, H // K, dim=2)
    s = torch.einsum("bqhd,blhd->bhql", q.float(), k.float()) * scale
    Tq, Tk = q.shape[1], k.shape[1]
    q_pos = torch.arange(Tq, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return s.masked_fill(~mask, _NEG_INF), mask


def _softmax_attention(q, k, v, scale, causal, window):
    """The output in v's dtype, and the masked scores it came from."""
    H, K = q.shape[2], k.shape[2]
    s, _ = _masked_scores(q, k, scale, causal, window)
    p = torch.softmax(s, dim=-1)
    if K != H:
        v = torch.repeat_interleave(v, H // K, dim=2)
    out = torch.einsum("bhql,blhd->bqhd", p, v.float())
    return out.to(v.dtype), s


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Quadratic softmax attention with GQA expansion.

    q [B,Tq,H,dk], k [B,Tk,K,dk], v [B,Tk,K,dv] → [B,Tq,H,dv] in v's dtype.
    Scores and softmax in fp32; masked scores are -1e30, as in the reference.
    """
    return _softmax_attention(q, k, v, _scale(q, scale), causal, window)[0]


def flash_attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref`'s output and each row's log-sum-exp.

    lse is fp32 ``[B,H,Tq]``: ``log sum_k exp(scale * q.k)`` in natural-log
    units of the scaled scores, over the keys the mask leaves (a row with
    none gets about -1e30 here; the kernels write -inf).
    """
    out, s = _softmax_attention(q, k, v, _scale(q, scale), causal, window)
    return out, torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_ref` from the flash-backward
    equations, in fp32: ``D = rowsum(dout * out)``, ``P = exp(scale S - lse)``,
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP - D)``, ``dQ = scale dS K``,
    ``dK = scale dS^T Q``; dk and dv are summed over each GQA group in fp32
    and cast to the input dtype once.

    A row with no unmasked key takes the uniform P that the oracle's softmax
    over its -1e30 scores gives (its lse cannot carry the log of the key
    count), and masked scores pass no dS, as the oracle's ``masked_fill``
    passes no gradient; so this matches the oracle's autograd on every row.
    """
    B, Tq, H, dk = q.shape
    _, Tk, K, dv = v.shape
    G = H // K
    sc = _scale(q, scale)
    s, mask = _masked_scores(q, k, sc, causal, window)
    empty = ~mask.any(-1)[:, None]
    p = torch.where(empty, 1.0 / Tk, torch.exp(s - lse.float()[..., None]))
    kf, vf = k.float(), v.float()
    if G > 1:
        kf = torch.repeat_interleave(kf, G, dim=2)
        vf = torch.repeat_interleave(vf, G, dim=2)
    do = dout.float()
    d = (do * out.float()).sum(-1).transpose(1, 2)  # [B,H,Tq]
    dv_h = torch.einsum("bhql,bqhd->blhd", p, do)
    dp = torch.einsum("bqhd,blhd->bhql", do, vf)
    ds = torch.where(mask, p * (dp - d[..., None]), 0.0)
    dq = torch.einsum("bhql,blhd->bqhd", ds, kf) * sc
    dk_h = torch.einsum("bhql,bqhd->blhd", ds, q.float()) * sc
    dk_ = dk_h.reshape(B, Tk, K, G, dk).sum(3)
    dv_ = dv_h.reshape(B, Tk, K, G, dv).sum(3)
    return dq.to(q.dtype), dk_.to(k.dtype), dv_.to(v.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Sequential linear recurrence h_t = a_t h_{t-1} + b_t. [B,T,W] fp32.

    The steps are stacked rather than written into one buffer, so that the
    autograd graph the backward recomputes stays linear in T."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else torch.empty_like(a)
