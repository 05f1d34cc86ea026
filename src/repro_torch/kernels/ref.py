"""Plain PyTorch versions of the kernels (quadratic attention, sequential scan).

Port of ``repro/kernels/ref.py``.  The CPU path of ``ops`` runs these, and the
card's checks hold each kernel against them on the same inputs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Quadratic softmax attention with GQA expansion.

    q [B,Tq,H,dk], k [B,Tk,K,dk], v [B,Tk,K,dv] → [B,Tq,H,dv] in v's dtype.
    Scores and softmax in fp32; masked scores are -1e30, as in the reference.
    """
    B, Tq, H, dk = q.shape
    _, Tk, K, dv = v.shape
    G = H // K
    if K != H:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    s = torch.einsum("bqhd,blhd->bhql", q.float(), k.float()) * scale
    q_pos = torch.arange(Tq, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhql,blhd->bqhd", p, v.float())
    return out.to(v.dtype)


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
