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
  come back the same way.  Where the experts do not divide over their ranks
  (``fit_pspec`` leaves ``wi`` and ``wo`` whole), every model rank runs
  every expert on the input before *f*: the output is whole and joins
  after *g*.

The microbatch is the rows of every rank on the step's row axes (``rows``:
``("pod", "data")`` in ``flat`` training and in every serving step, the
reference's batch axes; ``("data",)`` in ``sync`` and ``local``, whose
``vmap`` over pods routes each pod's rows alone).  Group g of G is the
tokens ``[g·S/G, (g+1)·S/G)`` of its S tokens, in (row, position) order
with the rows pod-major over the row ranks, whatever the row ranks' count:
a rank's *pieces* are where its tokens meet the groups (:func:`pieces`).
Where a group spans row ranks, one all-gather over them of each rank's
``[G, E]`` counts gives each piece its slot offsets (its group's counts on
the ranks before it) and its group's counts (:func:`_piece_offsets`); a
rank fills only its own pieces' slots.  The island routes each model
rank's slice of a rank's own rows; its capacity is per source slice on any
row axes.  It raises where the reference's island raises: expert weights
that its ``shard_map`` cannot split evenly.

Either way the router runs whole on every model rank, on the FFN input
before *f*, and where the experts split its gates pass through *f*: a model
rank's experts (or token slice) see only their share of the gates'
gradient, which *f* sums, so the router's weights get the same whole
gradient on every model rank.  The experts that split read the input after
*f*.
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


def _ranks(router: torch.Tensor, x: torch.Tensor, m: MoEConfig, piece: torch.Tensor,
           n_pieces: int):
    """The fp32 router over the tokens x [N, D], cut into ``n_pieces`` pieces
    (``piece`` [N]: each token's, ascending): gates [N, k], the experts of
    the (token, choice) pairs in (token, k) order [N*k], each pair's rank
    among its piece's pairs of its expert [N*k], the counts [P, E] and the
    probabilities [N, E]."""
    N = x.shape[0]
    E, k = m.num_experts, m.top_k
    probs = _router_probs(x.float() @ router, m)            # fp32 [N, E]
    gates, idx = _topk_gates(probs, m)                      # [N, k]
    flat_e = idx.reshape(N * k)
    key = piece.repeat_interleave(k) * E + flat_e           # (piece, expert)
    order = torch.argsort(key, stable=True)
    ranks = torch.empty_like(order).scatter_(0, order, torch.arange(N * k, device=x.device))
    counts = torch.zeros(n_pieces * E, dtype=torch.int64, device=x.device).scatter_add_(
        0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, dim=0) - counts           # exclusive prefix
    return gates, flat_e, ranks - starts[key], counts.view(n_pieces, E), probs


def _slots(flat_e: torch.Tensor, pos: torch.Tensor, C: int, E: int,
           local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each (token, choice)'s row of its piece's capacity buffer of the
    experts ``local`` (their global ids; every expert when None): the
    expert's index there times C plus its position; ``n·C`` (n experts) for
    a choice that drops (position C or more) or goes to an expert of another
    rank."""
    if local is None:
        return torch.where(pos < C, flat_e * C + pos, E * C)   # overflow → dropped
    n = local.numel()
    index = torch.full((E,), -1, dtype=torch.int64, device=flat_e.device)
    index[local] = torch.arange(n, device=flat_e.device)
    li = index[flat_e]
    return torch.where((pos < C) & (li >= 0), li * C + pos, n * C)


def _route(p, xg: torch.Tensor, m: MoEConfig, C: int):
    """Router and capacity slots of xg's G whole groups [G, S, D]: (gates
    [G, S, k] fp32, slot [G, S*k] in (token, k) order, E*C for a dropped
    choice, aux)."""
    G, S, D = xg.shape
    E, k = m.num_experts, m.top_k
    piece = torch.arange(G, device=xg.device).repeat_interleave(S)
    gates, flat_e, pos, counts, probs = _ranks(p["router"], xg.reshape(G * S, D), m, piece, G)
    aux = aux_load_balance_loss(probs.view(G, S, E), counts, m)
    return gates.view(G, S, k), _slots(flat_e, pos, C, E).view(G, S * k), aux


class Rows(NamedTuple):
    """The ranks whose rows make up a step's microbatch: ``mesh`` (any
    ``launch.mesh.Mesh``, sharded or not) and the ``axes`` the rows lie on."""

    mesh: Any
    axes: Tuple[str, ...] = ROWS


class Pieces(NamedTuple):
    """Where a rank's N tokens meet the microbatch's routing groups: piece j
    is the rank's tokens ``[starts[j], starts[j + 1])``, of group
    ``groups[j]``; ``group_size`` tokens a group, ``n_groups`` groups over
    ``n_rows`` row ranks, of which the rank is ``index``; ``rows`` where a
    group spans more than one row rank (None: every group lies whole on a
    rank); ``width``, the most pieces a row rank holds."""

    groups: Tuple[int, ...]
    starts: Tuple[int, ...]
    group_size: int
    n_groups: int
    n_rows: int
    index: int
    rows: Optional[Rows]
    width: int


def pieces(n: int, m: MoEConfig, rows: Optional[Rows] = None) -> Pieces:
    """The pieces of a rank's ``n`` tokens (its rows, in (row, position)
    order) among the reference's G groups of the microbatch over ``rows``
    (None: this rank's alone): G is ``m.groups`` where it divides the
    microbatch's S tokens, else 1; group g is the tokens ``[g·S/G, (g+1)·S/G)``
    of the rows pod-major over the row ranks, and row rank r holds
    ``[r·n, (r+1)·n)``."""
    i, R = row_rank(rows.mesh, rows.axes) if rows is not None else (0, 1)
    S = n * R
    G = m.groups if (m.groups >= 1 and S % m.groups == 0) else 1
    Sg = S // G

    def cut(r: int):
        lo, hi = r * n, (r + 1) * n
        gs = tuple(range(lo // Sg, -(-hi // Sg)))
        return gs, tuple(max(lo, g * Sg) - lo for g in gs) + (n,)

    groups, starts = cut(i)
    whole = n % Sg == 0
    width = len(groups) if whole else max(len(cut(r)[0]) for r in range(R))
    return Pieces(groups, starts, Sg, G, R, i, None if whole else rows, width)


def _piece_offsets(counts: torch.Tensor, pc: Pieces) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each piece's ``[E]`` offsets: the counts of its group's pieces on the
    row ranks before this one; its group's ``[E]`` counts), ``[P, E]`` each,
    from the pieces' ``counts`` ``[P, E]``.  Where a group spans row ranks,
    one all-gather over them of a ``[G, E]`` int64 tensor that holds the
    rank's counts in its pieces' rows; else no exchange (zeros, the rank's
    own counts)."""
    if pc.rows is None:
        return torch.zeros_like(counts), counts
    G, E = pc.n_groups, counts.shape[1]
    g = torch.arange(pc.groups[0], pc.groups[-1] + 1, device=counts.device)  # consecutive
    mine = counts.new_zeros((G, E)).index_copy(0, g, counts)
    every = pc.rows.mesh.all_gather(mine.reshape(-1), pc.rows.axes).view(-1, G, E)
    return every[:pc.index].sum(0)[g], every.sum(0)[g]


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


def _combine(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
             piece: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's k rows of ye [P, n·C, D] (row n·C: zeros), the (token,
    choice) pairs' ``slot`` [N*k] in the buffer of their ``piece`` [N*k]
    (None: 0), weighted by the gates [N, k] and summed over k in a fixed
    order → [N, D]."""
    N, k = gates.shape
    ye = torch.cat([ye, ye.new_zeros((ye.shape[0], 1, ye.shape[-1]))], dim=1)
    piece = torch.zeros_like(slot) if piece is None else piece
    picked = ye[piece, slot] * gates.reshape(N * k, 1).to(ye.dtype)  # [N*k, D]
    return picked.reshape(N, k, -1).sum(dim=1)


def _scatter_moe(p, xg: torch.Tensor, m: MoEConfig, xf: Optional[torch.Tensor] = None,
                 local: Optional[torch.Tensor] = None, tp=None, pc: Optional[Pieces] = None,
                 exchange=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg: [G, S, D] → (y [G, S, D], aux). Capacity overflow tokens drop.

    Over ranks: ``xf`` the tokens that the experts read (xg after *f*; the
    router reads xg), ``local`` the global ids of the experts whose slots
    this rank fills (every expert when None: y is then whole, else this
    rank's partial sum), ``tp`` the model axis (*f* on the gates), ``pc``
    the rank's :func:`pieces` (where a group spans row ranks, xg is ``[1,
    N, D]``, the rank's N tokens; else each of xg's rows is a piece, a
    whole group; None: one rank's whole groups): a piece's slots of an
    expert continue after those that its group's pieces on the row ranks
    before it filled, and the load-balance loss reads its group's counts;
    ``exchange`` the mesh where ``p``'s experts are one block of ``(data,
    model)`` and ``local`` those of the rank's model coordinate on every
    data rank (:func:`_exchanged_experts`)."""
    G, S, D = xg.shape
    E, k = m.num_experts, m.top_k
    N = G * S
    if pc is None:
        starts = tuple(range(0, N + 1, S))
        pc = Pieces(tuple(range(G)), starts, S, G, 1, 0, None, G)
    P, Sg = len(pc.groups), pc.group_size
    C = _capacity(Sg, m)
    x = xg.reshape(N, D)
    xf = x if xf is None else xf.reshape(N, D)
    bounds = list(zip(pc.starts, pc.starts[1:]))
    piece = (torch.arange(P, device=x.device).repeat_interleave(S) if pc.rows is None else
             torch.cat([torch.full((b - a,), j, dtype=torch.int64, device=x.device)
                        for j, (a, b) in enumerate(bounds)]))                   # [N]
    pair = piece.repeat_interleave(k)                                           # [N*k]
    if pc.rows is None and local is None:      # xg's rows whole groups, every expert
        gates, slot, aux = _route(p, xg, m, C)
        gates, slot = gates.reshape(N, k), slot.reshape(N * k)
    else:
        gates, flat_e, pos, counts, probs = _ranks(p["router"], x, m, piece, P)
        offset, total = _piece_offsets(counts, pc)
        pos = pos + offset[pair, flat_e]
        # E·Σ f·p over the groups: f from the group's counts, p this piece's
        # probabilities summed over the group's size, so that the mean over
        # the row ranks is the reference's mean over the groups.
        psum = torch.stack([probs[a:b].float().sum(0) for a, b in bounds])
        f = total.float() / (Sg * k)
        aux = (pc.n_rows / pc.n_groups) * E * torch.sum(f * psum) / Sg
        gates = copy_to_model(gates, tp)
        slot = _slots(flat_e, pos, C, E, local)
    n = E if local is None else local.numel()
    # Buffers: exchanged over data, every data rank's the same count.
    width = pc.width if exchange is not None else P
    token_of = torch.arange(N, device=x.device).repeat_interleave(k)

    # Each kept slot receives one token; row n*C collects the dropped ones
    # and is cut off unread.
    xe = xf.new_zeros((width, n * C + 1, D)).index_put((pair, slot), xf[token_of])
    xe = xe[:, :n * C].reshape(width, n, C, D)
    ye = (_experts(p["wi"], p["wo"], xe) if exchange is None
          else _exchanged_experts(p["wi"], p["wo"], xe, exchange))
    return _combine(ye.reshape(width, n * C, D), slot, gates, pair).view(G, S, D), aux


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
    slices = x.unflatten(1, (M, Tl)).transpose(0, 1).reshape(M * S, D)
    piece = torch.arange(M, device=x.device).repeat_interleave(S)
    gates, flat_e, pos, counts, probs = _ranks(p["router"], slices, m, piece, M)
    aux = aux_load_balance_loss(probs.view(M, S, E), counts, m)
    mine = slice(mi * S * k, (mi + 1) * S * k)
    gates = copy_to_model(gates, model_parallel(mesh))[mi * S:(mi + 1) * S]
    C = _capacity(S, m)                          # per (source, expert)
    slot = _slots(flat_e[mine], pos[mine], C, E)                # [S*k]
    token_of = torch.arange(S, device=x.device).repeat_interleave(k)
    xs = xf[:, mi * Tl:(mi + 1) * Tl].reshape(S, D)

    send = xs.new_zeros((E * C + 1, D)).index_put((slot,), xs[token_of])
    recv = all_to_all(send[:E * C].view(ep, e_loc * C, D), axes, mesh)
    # My experts' slots from every source: [e_loc, ep·C, D].
    xe = recv.view(ep, e_loc, C, D).transpose(0, 1).reshape(1, e_loc, ep * C, D)
    ye = _experts(p["wi"], p["wo"], xe)[0]
    ye = ye.reshape(e_loc, ep, C, D).transpose(0, 1).reshape(ep, e_loc * C, D)
    back = all_to_all(ye, axes, mesh).reshape(1, E * C, D)
    y = _combine(back, slot, gates)
    return gather_slices(y.reshape(B, Tl, D), model_parallel(mesh), dim=1), aux


def _island_refusal(cfg: ModelConfig, mesh) -> Optional[str]:
    """Why the reference's island (``_manual_ep_moe``) raises on ``mesh``, or
    None: its ``shard_map`` takes ``wi`` and ``wo`` split over ``P("model",
    "data")`` (experts on model, the dims after them on data), or over
    ``P(("data", "model"))`` for the 2-D layout, and raises where a dim does
    not divide."""
    m = cfg.moe
    E, D, Fe = m.num_experts, cfg.d_model, m.d_expert
    Dn, M = mesh.size("data"), mesh.size("model")
    if two_d(m):
        need = {f"{E} experts over data x model {Dn * M}": E % (Dn * M)}
    else:
        need = {f"{E} experts over model {M}": E % M,
                f"wi's d_model {D} over data {Dn}": D % Dn,
                f"wo's FFN dim {Fe} over data {Dn}": Fe % Dn}
    bad = [what for what, rest in need.items() if rest]
    if not bad:
        return None
    return (f"{cfg.name}: the expert-parallel island (ep_a2a on model {M}) needs its expert "
            "weights split evenly, as the reference's shard_map does: " + ", ".join(bad)
            + " do not divide")


def _local_experts(p, m: MoEConfig, mesh) -> Tuple[Optional[torch.Tensor], Any]:
    """(the global ids of the experts whose slots this rank fills, or None
    for all; the mesh of :func:`_exchanged_experts`, or None) of the scatter
    path over ``mesh``: experts on ``model``, the rank's own; experts on
    ``(data, model)`` jointly, block ``d·M + mi`` of each data rank ``d`` in
    data order, their slots exchanged over ``data``; experts that do not
    divide over their ranks (``fit_pspec`` leaves them whole), all."""
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
    is, the routed experts' whole output where every model rank holds every
    expert (read from x, its gates through no *f*), the shared experts' and
    the scatter path's partial sums through *g*.  ``rows``: the ranks whose
    rows make up the microbatch (None: this rank's alone), over which the
    scatter path's groups lie.  Raises ``NotImplementedError`` where the
    island would run on expert weights that the reference's ``shard_map``
    cannot split (:func:`_island_refusal`)."""
    m = cfg.moe
    B, T, D = x.shape
    tp = model_parallel(mesh)
    xf = copy_to_model(x, tp)
    whole = y = None
    if m.expert_sharding == "ep_a2a" and tp is not None and T % tp.size("model") == 0:
        refusal = _island_refusal(cfg, mesh)
        if refusal:
            raise NotImplementedError(refusal)
        whole, aux = _island(p, x, xf, m, mesh)
    else:
        pc = pieces(B * T, m, rows)
        shape = (1, B * T, D) if pc.rows is not None else (len(pc.groups), pc.group_size, D)
        local, exchange = _local_experts(p, m, mesh)
        if local is None:  # every expert on every model rank: their whole output
            yg, aux = _scatter_moe(p, x.reshape(shape), m, pc=pc)
            whole = yg.reshape(B, T, D)
        else:
            yg, aux = _scatter_moe(p, x.reshape(shape), m, xf.reshape(shape), local, tp, pc,
                                   exchange)
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
