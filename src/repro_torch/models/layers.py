"""Shared layers: norms, MLPs, embeddings, RoPE, losses.

Port of ``repro/models/layers.py``: (spec function, plain function) pairs over
explicit parameter trees.  ``ashard`` has no counterpart: a rank computes on
its own block of each activation (``sharding/shard.py``).  Where the vocab
dim is sharded over ``model`` (``tp``: the rank's mesh), the embedding looks
up the rank's vocab range and sums over ``model``, and the cross-entropy
reads vocab-sharded logits, summing the max, the exponents and the label's
logit over ``model``; the ``[B, T, V]`` logits are never gathered.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sharding.shard import copy_to_model, gather_slices, max_over_model, reduce_from_model
from .specs import ParamSpec


# ------------------------------------------------------------------- norms --
def rmsnorm_spec(d: int, dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones", dtype=dtype)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * p["scale"].float()).to(x.dtype)


def layernorm_spec(d: int, dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    return {
        "scale": ParamSpec((d,), ("embed",), init="ones", dtype=dtype),
        "bias": ParamSpec((d,), ("embed",), init="zeros", dtype=dtype),
    }


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, correction=0)  # jnp.var: population
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * p["scale"].float() + p["bias"].float()).to(x.dtype)


# -------------------------------------------------------------------- MLPs --
def mlp_spec(d_model: int, d_ff: int, act: str, dtype=torch.bfloat16) -> Dict:
    width = 2 * d_ff if act == "swiglu" else d_ff
    return {
        # swiglu: fused gate+up projection, split as [gate | up].
        "wi": ParamSpec((d_model, width), ("embed", "mlp"), dtype=dtype),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        return F.silu(gate) * up
    if act == "gelu":
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    raise ValueError(f"unknown activation {act}")


def mlp(p, x: torch.Tensor, act: str, tp=None, d_ff: Optional[int] = None) -> torch.Tensor:
    """The FFN of ``x``.  ``tp`` (the model axis; ``x`` before *f*, ``d_ff``
    the whole FFN width): the output whole, by the layout that
    ``sharding.shard.param_layout`` gave the weights: ``wo``'s rows split
    (swiglu's ``wi`` as ``[gate_m | up_m]``), *f*, the rank's columns and
    *g*; ``wo`` whole and ``wi``'s columns split contiguously (a gate that
    does not split in two), *f* and the projection gathered whole over
    ``model``, the rest whole on every rank; both whole, no exchange."""
    wi, wo = p["wi"], p["wo"]
    if tp is None or wi.shape[-1] == (2 if act == "swiglu" else 1) * d_ff:
        return _activate(x @ wi, act) @ wo
    h = copy_to_model(x, tp) @ wi
    if wo.shape[0] < d_ff:
        return reduce_from_model(_activate(h, act) @ wo, tp)
    return _activate(gather_slices(h, tp, -1), act) @ wo


# -------------------------------------------------------------- embeddings --
def embed_spec(vocab: int, d_model: int, dtype=torch.bfloat16) -> Dict:
    return {
        "table": ParamSpec(
            (vocab, d_model), ("vocab", "embed"), init="embed", scale=0.02, dtype=dtype
        )
    }


def embed(p, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The rows of ``p["table"]`` for ``tokens``.  ``tp``: the table holds
    the rank's vocab range ``[m·V/M, (m+1)·V/M)``; tokens outside it look
    up zeros, and the sum over ``model`` gives every rank the whole
    embedding (each token's row comes from exactly one rank)."""
    if tp is None:
        return F.embedding(tokens, p["table"])
    rows = p["table"].shape[0]
    local = tokens - tp.coords["model"] * rows
    inside = (local >= 0) & (local < rows)
    out = F.embedding(torch.where(inside, local, 0), p["table"])
    return reduce_from_model(torch.where(inside[..., None], out, 0), tp)


def unembed_spec(vocab: int, d_model: int, dtype=torch.bfloat16) -> Dict:
    return {"w": ParamSpec((d_model, vocab), ("embed", "vocab"), dtype=dtype)}


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


# -------------------------------------------------------------------- RoPE --
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split convention, angles in fp32.

    x: [..., T, H, d] (d even); positions: broadcastable to [..., T].
    """
    half = x.shape[-1] // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freq        # [..., T, half]
    cos = torch.cos(ang)[..., None, :]               # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ losses --
def _nll(logits: torch.Tensor, labels: torch.Tensor, tp=None) -> torch.Tensor:
    """Per-position ``logsumexp - gold`` in fp32.  The gold logit is a gather:
    the reference's one-hot contraction exists for XLA's partitioner and gives
    the same fp32 value.  ``tp``: ``logits`` are the rank's vocab range; the
    max (no gradient: logsumexp's does not depend on it), the sum of
    exponents and the label's logit are summed over ``model``."""
    logits = logits.float()
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logz - gold
    V = logits.shape[-1]
    m = max_over_model(logits.detach().amax(dim=-1), tp)
    sumexp = reduce_from_model(torch.sum(torch.exp(logits - m[..., None]), dim=-1), tp)
    local = labels.long() - tp.coords["model"] * V
    inside = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, gold, 0.0), tp)
    return m + torch.log(sumexp) - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """Mean cross-entropy in fp32. logits [..., V] (``tp``: the rank's vocab
    range), labels int [...]."""
    nll = _nll(logits, labels, tp)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def chunked_xent(hidden: torch.Tensor, logits_fn: Callable[[torch.Tensor], torch.Tensor],
                 labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 chunk: int = 1024, tp=None) -> torch.Tensor:
    """Cross-entropy without materialising [B, T, V] logits.

    Chunks of ``chunk`` positions along T, in order, each under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` scan body),
    so that one chunk's logits live at a time in forward and backward.
    ``logits_fn(h_chunk) -> [B, c, V]``.  Falls back to :func:`softmax_xent`
    when T is not a multiple of ``chunk``.  ``tp``: ``logits_fn`` gives the
    rank's vocab range (:func:`_nll`).
    """
    B, T, _ = hidden.shape
    if T % chunk != 0:
        return softmax_xent(logits_fn(hidden), labels, mask, tp)
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=hidden.device)
    mask = mask.float()

    def body(hc, yc, mc):
        nll = _nll(logits_fn(hc), yc, tp) * mc
        return torch.sum(nll), torch.sum(mc)

    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T, chunk):
        s, c = checkpoint(body, hidden[:, i:i + chunk], labels[:, i:i + chunk],
                          mask[:, i:i + chunk], use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)
