"""Mixture-of-Experts FFN (DeepSeek-style: shared + routed, fine-grained).

Port of ``repro/models/moe.py``.  Dispatch is capacity-based, group-local
and free of one-hot tensors: tokens are split into G groups
(``MoEConfig.groups``), each group ranks its (token, choice) pairs per
expert by a stable sort, scatters them into a ``[G, E, C, D]`` capacity
buffer, runs the expert products as one batched product, and gathers the
outputs back weighted by the router's gates.  Choices past an expert's
capacity C drop, in the reference's order: the first C of an expert's
(token, choice) pairs in (token, k) order keep their slots.

The combine sums each token's k gated rows over k in a fixed order (the
reference scatter-adds them), so a run on the card repeats bit for bit.
The dense one-hot dispatch (:func:`_onehot_moe`) is the numerical oracle of
the tests, as in the reference.

Over the ranks of a ``(data, model)`` mesh (``launch.mesh.Mesh``) the
reference's two routes:

* the expert-parallel island (``expert_sharding="ep_a2a"`` with ``model``
  above 1 and T a multiple of it; the reference's ``_manual_ep_moe``): each
  model rank takes its ``T / M`` slice of every row as a group of its own,
  fills an ``[ep, e_loc·C, D]`` send buffer (capacity C per source and
  expert), sends each expert's slots to the rank that owns it in one
  all-to-all over the EP group (``model``; ``(data, model)`` where E
  divides by 256, one block of experts a rank), runs its own experts,
  returns the results by a second all-to-all, combines them, and gathers
  the slices over ``model``: its output is whole on every model rank;
* otherwise the scatter path (``fsdp_d``, ``fsdp_f``, ``ep2d``, and the
  island's fallback, decode among it): every model rank routes the same
  tokens in the reference's groups of the whole microbatch, runs its own
  experts only and leaves a partial sum for the block's *g*.  The experts
  lie on ``model`` (``fsdp_d``, ``fsdp_f``: the model gathers their FSDP dim
  on use), or on ``(data, model)`` jointly (``ep2d``, the island's 2-D
  layout), where the weights never move: the slots of the experts that data
  rank ``d`` holds go to it by an all-to-all over ``data``, and the results
  come back the same way.

The microbatch is the rows of every rank on the step's row axes (``rows``:
``("pod", "data")`` in ``flat`` training and in every serving step, the
reference's batch axes; ``("data",)`` in ``sync`` and ``local``, whose
``vmap`` over pods routes each pod's rows alone).  With R row ranks and G
groups, a rank holds G / R whole groups, or, where R / G is whole, one group
spans R / G consecutive row ranks: an expert's slots continue across them in
pod-major order (an all-gather of the ``[E]`` counts over the row ranks, of
which each group reads its own ranks').  The island routes each model
rank's slice of a rank's own rows; its capacity is per source slice on any
row axes.

Either way the router runs whole on every model rank, on the FFN input
before *f*, and its gates pass through *f*: a model rank's experts (or
token slice) see only their share of the gates' gradient, which *f* sums,
so the router's weights get the same whole gradient on every model rank.
The experts read the input after *f*.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..sharding.shard import (all_to_all, copy_to_model, gather_slices, model_parallel,
                              model_split, reduce_from_model, ROWS, row_rank)
from .layers import mlp, mlp_spec
from .specs import ParamSpec


LAYOUTS = ("fsdp_d", "fsdp_f", "ep2d", "ep_a2a")


def two_d(m: MoEConfig) -> bool:
    """Whether the experts lie on ``(data, model)`` jointly, one block a rank:
    ``ep2d``, and the island's ``E % 256 == 0`` branch."""
    return m.expert_sharding == "ep2d" or (m.expert_sharding == "ep_a2a"
                                           and m.num_experts % 256 == 0)


def moe_spec(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    m: MoEConfig = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_expert
    # (wi, wo) logical axes (MoEConfig.expert_sharding): experts on model with
    # d_model (fsdp_d) or the FFN dim (fsdp_f) FSDP on data, experts on (data,
    # model) jointly (ep2d, the island's E % 256 layout), or the island's
    # experts on model with wi's d_model and wo's FFN dim on data.
    if two_d(m):
        wi_l = wo_l = ("expert2d", None, None)
    elif m.expert_sharding == "ep_a2a":
        wi_l, wo_l = ("expert", "embed", None), ("expert", "mlp_fsdp", None)
    elif m.expert_sharding == "fsdp_f":
        wi_l, wo_l = ("expert", None, "mlp_fsdp"), ("expert", "mlp_fsdp", None)
    else:
        wi_l, wo_l = ("expert", "embed", None), ("expert", None, "embed")
    spec: Dict = {
        # The router stays fp32 whatever the model's dtype.
        "router": ParamSpec((D, E), ("embed", None), init="normal", scale=0.006,
                            dtype=torch.float32),
        # Fused gate+up per expert.
        "wi": ParamSpec((E, D, 2 * Fe), wi_l, dtype=dtype),
        "wo": ParamSpec((E, Fe, D), wo_l, dtype=dtype),
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


def _ranks(router: torch.Tensor, xg: torch.Tensor, m: MoEConfig):
    """The fp32 router over xg [G, S, D]: gates [G, S, k], the experts of
    the (token, choice) pairs in (token, k) order [G, S*k], each pair's
    rank among its expert's pairs [G, S*k], the counts [G, E] and the
    probabilities [G, S, E]."""
    G, S, _ = xg.shape
    E, k = m.num_experts, m.top_k
    probs = _router_probs(xg.float() @ router, m)           # fp32 [G, S, E]
    gates, idx = _topk_gates(probs, m)                      # [G, S, k]
    flat_e = idx.reshape(G, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(             # rank within group
        -1, order, torch.arange(S * k, device=xg.device).expand(G, -1))
    counts = torch.zeros((G, E), dtype=torch.int64, device=xg.device).scatter_add_(
        -1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts          # exclusive prefix
    pos = ranks - torch.gather(starts, -1, flat_e)
    return gates, flat_e, pos, counts, probs


def _slots(flat_e: torch.Tensor, pos: torch.Tensor, C: int, E: int,
           local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each (token, choice)'s row of the capacity buffer of the experts
    ``local`` (their global ids; every expert when None): the expert's index
    there times C plus its position; ``n·C`` (n experts) for a choice that
    drops (position C or more) or goes to an expert of another rank."""
    if local is None:
        return torch.where(pos < C, flat_e * C + pos, E * C)   # overflow → dropped
    n = local.numel()
    index = torch.full((E,), -1, dtype=torch.int64, device=flat_e.device)
    index[local] = torch.arange(n, device=flat_e.device)
    li = index[flat_e]
    return torch.where((pos < C) & (li >= 0), li * C + pos, n * C)


def _route(p, xg: torch.Tensor, m: MoEConfig, C: int):
    """Router and capacity slots of xg [G, S, D]: (gates [G, S, k] fp32,
    slot [G, S*k] in (token, k) order, E*C for a dropped choice, aux)."""
    gates, flat_e, pos, counts, probs = _ranks(p["router"], xg, m)
    aux = aux_load_balance_loss(probs, counts, m)
    return gates, _slots(flat_e, pos, C, m.num_experts), aux


class Rows(NamedTuple):
    """The ranks whose rows make up a step's microbatch: ``mesh`` (any
    ``launch.mesh.Mesh``, sharded or not) and the ``axes`` the rows lie on."""

    mesh: Any
    axes: Tuple[str, ...] = ROWS


class Span(NamedTuple):
    """One group over ``size`` consecutive row ranks of ``rows``; ``index``
    is this rank's, pod-major over ``rows.axes``."""

    rows: Rows
    size: int
    index: int


def _span_offsets(counts: torch.Tensor, span: Span) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ``[E]`` counts of the group's ranks before this one, the
    group's counts) from every row rank's ``counts`` (one all-gather over the
    row ranks; the group reads its own ranks')."""
    mesh, axes = span.rows
    every = mesh.all_gather(counts, axes).view(-1, counts.numel())
    lo = span.index - span.index % span.size
    return every[lo:span.index].sum(0), every[lo:lo + span.size].sum(0)


def _experts(wi: torch.Tensor, wo: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """The experts' swiglu FFN over their slots, xe [G, e, C, D]."""
    h = torch.einsum("gecd,edf->gecf", xe, wi)
    gate_h, up_h = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate_h) * up_h
    return torch.einsum("gecf,efd->gecd", h, wo)


def _exchanged_experts(wi: torch.Tensor, wo: torch.Tensor, xe: torch.Tensor, mesh
                       ) -> torch.Tensor:
    """:func:`_experts` where the rank holds one block of ``n`` experts of
    ``(data, model)`` jointly and ``xe`` ``[G, Dn·n, C, D]`` holds the slots
    of the experts of its model coordinate on every data rank, in data
    order: the weights stay, and the slots go to their experts' data rank
    and come back by two all-to-alls over ``data``."""
    G, L, C, D = xe.shape
    Dn, n = mesh.size("data"), wi.shape[0]
    send = xe.reshape(G, Dn, n, C, D).transpose(0, 1)               # piece d → data rank d
    recv = all_to_all(send, "data", mesh)          # my experts' slots from every data rank
    ye = _experts(wi, wo, recv.reshape(Dn * G, n, C, D))
    back = all_to_all(ye.reshape(Dn, G, n, C, D), "data", mesh)
    return back.transpose(0, 1).reshape(G, L, C, D)


def _combine(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Each token's k rows of ye [G, n·C, D] (row n·C: zeros) weighted by
    the gates [G, S, k] and summed over k in a fixed order → [G, S, D]."""
    G, S, k = gates.shape
    ye = torch.cat([ye, ye.new_zeros((G, 1, ye.shape[-1]))], dim=1)
    garange = torch.arange(G, device=ye.device)[:, None]
    picked = ye[garange, slot] * gates.reshape(G, S * k, 1).to(ye.dtype)  # [G, S*k, D]
    return picked.reshape(G, S, k, -1).sum(dim=2)


def _scatter_moe(p, xg: torch.Tensor, m: MoEConfig, xf: Optional[torch.Tensor] = None,
                 local: Optional[torch.Tensor] = None, tp=None, span: Optional[Span] = None,
                 exchange=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg: [G, S, D] → (y [G, S, D], aux). Capacity overflow tokens drop.

    Over ranks: ``xf`` the tokens that the experts read (xg after *f*; the
    router reads xg), ``local`` the global ids of the experts whose slots
    this rank fills (every expert when None: y is then whole, else this
    rank's partial sum), ``tp`` the model axis (*f* on the gates), ``span``
    where xg's one group spans several row ranks: an expert's slots continue
    after those the group's ranks before this one filled, and the
    load-balance loss reads the whole group's counts; ``exchange`` the mesh
    where ``p``'s experts are one block of ``(data, model)`` and ``local``
    those of the rank's model coordinate on every data rank
    (:func:`_exchanged_experts`)."""
    G, S, D = xg.shape
    E, k = m.num_experts, m.top_k
    xf = xg if xf is None else xf
    n_span = span.size if span is not None else 1
    C = _capacity(S * n_span, m)
    if span is None and local is None:
        gates, slot, aux = _route(p, xg, m, C)
    else:
        gates, flat_e, pos, counts, probs = _ranks(p["router"], xg, m)
        if span is not None:
            offset, total = _span_offsets(counts.reshape(-1), span)
            pos = pos + offset[flat_e]
            # The group's counts with this rank's probabilities: the row
            # ranks' mean of this is the reference's loss over the groups.
            f = total.float() / (S * n_span * k)
            aux = m.num_experts * torch.sum(f * probs.float().mean(dim=1)[0])
        else:
            aux = aux_load_balance_loss(probs, counts, m)
        gates = copy_to_model(gates, tp)
        slot = _slots(flat_e, pos, C, E, local)
    n = E if local is None else local.numel()
    garange = torch.arange(G, device=xg.device)[:, None]
    token_of = torch.arange(S, device=xg.device).repeat_interleave(k)  # [S*k]

    # Each kept slot receives one token; row n*C collects the dropped ones
    # and is cut off unread.
    xe = xf.new_zeros((G, n * C + 1, D)).index_put((garange, slot), xf[:, token_of])
    xe = xe[:, :n * C].reshape(G, n, C, D)
    ye = (_experts(p["wi"], p["wo"], xe) if exchange is None
          else _exchanged_experts(p["wi"], p["wo"], xe, exchange))
    return _combine(ye.reshape(G, n * C, D), slot, gates), aux


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


def _island(p, x: torch.Tensor, xf: torch.Tensor, m: MoEConfig, mesh
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel island (the reference's ``_manual_ep_body``):
    x and xf ``[B, T, D]`` (the rank's rows, before and after *f*) → (y
    ``[B, T, D]`` whole on every model rank, aux).  The router runs on every
    slice, so that aux is the slices' mean (the reference's ``pmean`` over
    ``model``) on every model rank alike; the rank sends its own slice."""
    M, mi = mesh.size("model"), mesh.coords["model"]
    B, T, D = x.shape
    E, k = m.num_experts, m.top_k
    axes = ("data", "model") if two_d(m) else "model"
    ep = M * (mesh.size("data") if two_d(m) else 1)
    e_loc = E // ep
    Tl = T // M
    S = B * Tl
    # Group i: model rank i's slice of every row, in (row, position) order.
    slices = x.unflatten(1, (M, Tl)).transpose(0, 1).reshape(M, S, D)
    gates, flat_e, pos, counts, probs = _ranks(p["router"], slices, m)
    aux = aux_load_balance_loss(probs, counts, m)
    gates = copy_to_model(gates, model_parallel(mesh))[mi:mi + 1]
    C = _capacity(S, m)                          # per (source, expert)
    slot = _slots(flat_e[mi:mi + 1], pos[mi:mi + 1], C, E)       # [1, S*k]
    token_of = torch.arange(S, device=x.device).repeat_interleave(k)
    xs = xf[:, mi * Tl:(mi + 1) * Tl].reshape(S, D)

    send = xs.new_zeros((E * C + 1, D)).index_put((slot[0],), xs[token_of])
    recv = all_to_all(send[:E * C].view(ep, e_loc * C, D), axes, mesh)
    # My experts' slots from every source: [e_loc, ep·C, D].
    xe = recv.view(ep, e_loc, C, D).transpose(0, 1).reshape(1, e_loc, ep * C, D)
    ye = _experts(p["wi"], p["wo"], xe)[0]
    ye = ye.reshape(e_loc, ep, C, D).transpose(0, 1).reshape(ep, e_loc * C, D)
    back = all_to_all(ye, axes, mesh).reshape(1, E * C, D)
    y = _combine(back, slot, gates.reshape(1, S, k))[0]
    return gather_slices(y.reshape(B, Tl, D), model_parallel(mesh), dim=1), aux


def _local_experts(p, m: MoEConfig, mesh) -> Tuple[Optional[torch.Tensor], Any]:
    """(the global ids of the experts whose slots this rank fills, or None
    for all; the mesh of :func:`_exchanged_experts`, or None) of the scatter
    path over ``mesh``: experts on ``model``, the rank's own; experts on
    ``(data, model)`` jointly, block ``d·M + mi`` of each data rank ``d`` in
    data order, their slots exchanged over ``data``."""
    n, E = p["wi"].shape[0], m.num_experts
    if n == E:
        return None, None
    M, mi = mesh.size("model"), mesh.coords["model"]
    if n * M == E:                                # experts on model
        return torch.arange(mi * n, (mi + 1) * n, device=p["wi"].device), None
    ids = [(d * M + mi) * n + j for d in range(mesh.size("data")) for j in range(n)]
    return torch.tensor(ids, device=p["wi"].device), mesh


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, mesh=None, rows: Optional[Rows] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: [B, T, D] → (y [B, T, D], aux scalar).

    On a sharded ``mesh`` x is the rank's rows, the same on every model rank
    (the FFN input before *f*), and y is whole: the island's output as it
    is, the shared experts' and the scatter path's partial sums through
    *g*.  ``rows``: the ranks whose rows make up the microbatch (None: this
    rank's alone), over which the scatter path's groups lie."""
    m = cfg.moe
    B, T, D = x.shape
    tp = model_parallel(mesh)
    xf = copy_to_model(x, tp)
    whole = None
    if m.expert_sharding == "ep_a2a" and tp is not None and T % tp.size("model") == 0:
        whole, aux = _island(p, x, xf, m, mesh)
        y = None
    else:
        i, R = row_rank(rows.mesh, rows.axes) if rows is not None else (0, 1)
        S = B * T * R                              # the microbatch's tokens
        G = m.groups if (m.groups >= 1 and S % m.groups == 0) else 1
        if G % R and R % G:
            raise NotImplementedError(
                f"{cfg.name}: {G} MoE groups over {R} row ranks {tuple(rows.axes)}: a group "
                "would straddle a rank (the reference's groups are whole on a rank or span "
                "whole ranks: neither of the counts divides the other)")
        g = max(G // R, 1)
        span = Span(rows, R // G, i) if G < R else None
        local, exchange = _local_experts(p, m, mesh)
        yg, aux = _scatter_moe(p, x.reshape(g, B * T // g, D), m, xf.reshape(g, B * T // g, D),
                               local, tp, span, exchange)
        y = yg.reshape(B, T, D)
    if m.num_shared:
        d_shared = m.num_shared * m.d_expert
        if model_split(tp, d_shared) is not None or tp is None:
            shared = mlp(p["shared"], xf, "swiglu")
            y = shared if y is None else y + shared
        else:  # the shared experts' width does not split: their output whole
            shared = mlp(p["shared"], x, "swiglu", tp, d_shared)
            whole = shared if whole is None else whole + shared
    if y is None:
        return whole, aux
    y = reduce_from_model(y, tp)
    return y if whole is None else whole + y, aux
