"""Mixture-of-Experts FFN (DeepSeek-style: shared + routed, fine-grained).

Port of ``repro/models/moe.py`` for one device.  Dispatch is capacity-based,
group-local and free of one-hot tensors: tokens are split into G groups
(``MoEConfig.groups``, 1 on one card), each group ranks its (token, choice)
pairs per expert by a stable sort, scatters them into a ``[G, E, C, D]``
capacity buffer, runs the expert products as one batched product, and
gathers the outputs back weighted by the router's gates.  Choices past an
expert's capacity C drop, in the reference's order: the first C of an
expert's (token, choice) pairs in (token, k) order keep their slots.

The combine sums each token's k gated rows over k in a fixed order (the
reference scatter-adds them), so a run on the card repeats bit for bit.
The dense one-hot dispatch (:func:`_onehot_moe`) is the numerical oracle of
the tests, as in the reference.  The reference's expert-parallel island
(``expert_sharding="ep_a2a"``, an all-to-all over a mesh) has no port: the
port runs on one device, where only the ``fsdp_d`` layout applies.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from .layers import mlp, mlp_spec
from .specs import ParamSpec


def moe_spec(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    m: MoEConfig = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_expert
    spec: Dict = {
        # The router stays fp32 whatever the model's dtype.
        "router": ParamSpec((D, E), ("embed", None), init="normal", scale=0.006,
                            dtype=torch.float32),
        # Fused gate+up per expert.
        "wi": ParamSpec((E, D, 2 * Fe), ("expert", "embed", None), dtype=dtype),
        "wo": ParamSpec((E, Fe, D), ("expert", None, "embed"), dtype=dtype),
    }
    if m.num_shared:
        spec["shared"] = mlp_spec(D, m.num_shared * Fe, "swiglu", dtype)
    return spec


def _router_probs(logits: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    if m.router == "softmax":      # DeepSeek-V2
        return torch.softmax(logits, dim=-1)
    if m.router == "sigmoid":      # DeepSeek-V3
        return torch.sigmoid(logits)
    raise ValueError(m.router)


def _topk_gates(probs: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    if m.router == "sigmoid":      # V3 renormalises among the selected
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def aux_load_balance_loss(probs: torch.Tensor, counts: torch.Tensor, m: MoEConfig):
    """Switch-style load-balance auxiliary: E · <f_e> · <p_e> (per group)."""
    G, S, E = probs.shape
    f = counts.float() / (S * m.top_k)                     # [G, E]
    p = probs.float().mean(dim=1)                          # [G, E]
    return torch.mean(m.num_experts * torch.sum(f * p, dim=-1))


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def _route(p, xg: torch.Tensor, m: MoEConfig, C: int):
    """Router and capacity slots of xg [G, S, D]: (gates [G, S, k] fp32,
    slot [G, S*k] in (token, k) order, E*C for a dropped choice, aux)."""
    G, S, _ = xg.shape
    E, k = m.num_experts, m.top_k
    logits = xg.float() @ p["router"]                       # fp32 [G, S, E]
    probs = _router_probs(logits, m)
    gates, idx = _topk_gates(probs, m)                      # [G, S, k]

    flat_e = idx.reshape(G, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(             # rank within group
        -1, order, torch.arange(S * k, device=xg.device).expand(G, -1))
    counts = torch.zeros((G, E), dtype=torch.int64, device=xg.device).scatter_add_(
        -1, flat_e, torch.ones_like(flat_e))
    aux = aux_load_balance_loss(probs, counts, m)
    starts = torch.cumsum(counts, dim=-1) - counts          # exclusive prefix
    pos = ranks - torch.gather(starts, -1, flat_e)
    slot = torch.where(pos < C, flat_e * C + pos, E * C)    # overflow → dropped
    return gates, slot, aux


def _scatter_moe(p, xg: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg: [G, S, D] → (y [G, S, D], aux). Capacity overflow tokens drop."""
    G, S, D = xg.shape
    E, k = m.num_experts, m.top_k
    C = _capacity(S, m)
    gates, slot, aux = _route(p, xg, m, C)
    garange = torch.arange(G, device=xg.device)[:, None]
    token_of = torch.arange(S, device=xg.device).repeat_interleave(k)  # [S*k]

    # Each kept slot receives one token; row E*C collects the dropped ones
    # and is cut off unread.
    xe = xg.new_zeros((G, E * C + 1, D)).index_put((garange, slot), xg[:, token_of])
    h = torch.einsum("gecd,edf->gecf", xe[:, :E * C].reshape(G, E, C, D), p["wi"])
    gate_h, up_h = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate_h) * up_h
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"]).reshape(G, E * C, D)
    ye = torch.cat([ye, ye.new_zeros((G, 1, D))], dim=1)

    picked = ye[garange, slot] * gates.reshape(G, S * k, 1).to(ye.dtype)  # [G, S*k, D]
    return picked.reshape(G, S, k, D).sum(dim=2), aux


def _onehot_moe(p, xg: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense one-hot dispatch: the tests' oracle (one group only)."""
    G, S, D = xg.shape
    if G != 1:
        raise ValueError("the one-hot oracle is ungrouped")
    x2d = xg[0]
    E, k = m.num_experts, m.top_k
    C = _capacity(S, m)

    probs = _router_probs(x2d.float() @ p["router"], m)
    gates, idx = _topk_gates(probs, m)
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    aux = aux_load_balance_loss(probs[None], counts[None], m)

    flat = F.one_hot(idx, E).reshape(S * k, E)              # [S*k, E]
    pos = torch.cumsum(flat, dim=0) - flat                  # exclusive prefix
    pos = torch.sum(pos * flat, dim=-1).reshape(S, k)
    keep = pos < C
    disp = (
        F.one_hot(idx, E).to(x2d.dtype)[..., None]
        * F.one_hot(torch.where(keep, pos, C), C + 1).to(x2d.dtype)[..., None, :]
    )[..., :C]                                              # [S, k, E, C]
    dispatch = torch.sum(disp, dim=1)                       # [S, E, C]
    combine = torch.sum(disp * gates[..., None, None].to(x2d.dtype), dim=1)

    xe = torch.einsum("sec,sd->ecd", dispatch, x2d)
    h = torch.einsum("ecd,edf->ecf", xe, p["wi"])
    gate_h, up_h = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate_h) * up_h
    ye = torch.einsum("ecf,efd->ecd", h, p["wo"])
    return torch.einsum("sec,ecd->sd", combine, ye)[None], aux


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: [B, T, D] → (y [B, T, D], aux scalar)."""
    m = cfg.moe
    B, T, D = x.shape
    S = B * T
    G = m.groups if (m.groups >= 1 and S % m.groups == 0) else 1
    yg, aux = _scatter_moe(p, x.reshape(G, S // G, D), m)
    y = yg.reshape(B, T, D)
    if m.num_shared:
        y = y + mlp(p["shared"], x, "swiglu")
    return y, aux
