"""FSDP and tensor parallelism over the ranks of a mesh: the explicit form
of what GSPMD does for the reference under ``sharding/rules.py``.

A rank of a ``(pod, data, model)`` mesh (``launch.mesh.Mesh``) holds, of every
parameter, the block that the fitted partition spec assigns it: ``1/D`` of
each dim on ``data`` (FSDP) and ``1/M`` of each dim on ``model`` (TP), in
the order of the rank's coordinates.  The one exception to a contiguous
split is a fused swiglu projection (``wi`` ``[D, 2·d_ff]`` = ``[gate |
up]``): each of its two blocks is split on its own, so that a model rank's
shard is ``[gate_m | up_m]`` and ``torch.chunk(h, 2)`` stays local
(:func:`fused_blocks`).  :func:`shard_tree` and :func:`gather_tree` agree on
that layout, and so does every checkpoint, which holds whole tensors.

The collectives of the sharded step, as autograd functions:

* :func:`gather_on_use` — all-gather a parameter's ``data`` dim in the
  forward; reduce-scatter its gradient over ``data`` in fp32 in the
  backward (a sum over the data ranks: the step divides it by ``D``);
* :func:`copy_to_model` (Megatron's *f*) — the identity in the forward, an
  all-reduce over ``model`` in the backward, before each column-parallel
  product (placed after the norm, so that a norm scale replicated on
  ``model`` gets the same gradient on every model rank);
* :func:`reduce_from_model` (Megatron's *g*) — an all-reduce over ``model``
  in the forward, the identity in the backward, after each row-parallel
  product;
* :func:`reduce_scatter_model` — the sum over ``model`` of a rank's
  partial products, the rank's slice of it kept, in the forward; the
  gradient all-gathered in the backward (the partials of a row-parallel
  product whose output feeds the rank's own channels or heads: the RG-LRU's
  gates, the mLSTM's input and forget gates);
* :func:`all_gather_model` — its adjoint: a tensor whole over ``model`` in
  the forward, the gradient summed over ``model`` and scattered in the
  backward (k and v gathered whole for a rank's query heads where the KV
  heads do not split over ``model``);
* :func:`all_reduce_model` — the sum over ``model`` in the forward and the
  backward, where the sum feeds rank-specific work (the mLSTM's group norm
  over the whole inner width).  *g*'s identity backward is right only where
  every model rank then computes the same thing: after *g*, a slice of the
  result would keep only the gradient of the rank's own slice;
* :func:`slice_model` — a parameter replicated over ``model`` cut to the
  rank's slice in the forward; its gradient, nonzero only on that slice on
  each rank, all-gathered in the backward so that every model rank holds
  the same whole gradient (the biases and decay of the RG-LRU's gates, the
  mLSTM's gate bias and group-norm scale);
* :func:`all_to_all` — the expert-parallel exchange (``models/moe.py``'s
  island): piece ``i`` of dim 0 to rank ``i`` of a group, the gradient back
  by the same exchange;
* :func:`gather_slices` — the island's output slices whole over ``model``;
  in the backward the rank keeps its own slice of the gradient.

The rules never name ``pod``: every pod holds the same blocks, sharded over
its own ``data`` and ``model`` ranks, and every collective above runs on a
group that lies inside a pod.  ``launch/steps.py`` reconciles the pods'
blocks over ``pod`` (``core/cohort.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

SHARD_AXES = ("data", "model")
# The axes that split a served, encoded or flat-trained batch's rows,
# pod-major: the reference's batch axes.
ROWS = ("pod", "data")


@dataclass(frozen=True)
class Placement:
    """One parameter's place on the mesh: its fitted partition spec (one
    entry per dim of the stored tensor) and the number of blocks its last dim
    is fused from (2 for swiglu's ``[gate | up]``)."""

    spec: Tuple
    blocks: int = 1

    def axes(self, dim: int) -> Tuple[str, ...]:
        entry = self.spec[dim] if dim < len(self.spec) else None
        return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)

    def dim_of(self, axis: str) -> Optional[int]:
        """The dim that ``axis`` shards, or None."""
        for d in range(len(self.spec)):
            if axis in self.axes(d):
                return d
        return None

    def replicas(self, mesh) -> int:
        """How many ranks of the (data, model) mesh hold each element."""
        used = {a for d in range(len(self.spec)) for a in self.axes(d)}
        return math.prod(mesh.size(a) for a in SHARD_AXES if a not in used)

    def blocks_of(self, dim: int) -> int:
        return self.blocks if dim == len(self.spec) - 1 else 1


def sharded(mesh) -> bool:
    """Whether ``mesh`` shards parameters: data or model above 1, whatever
    the number of pods."""
    return mesh is not None and (mesh.size("data") > 1 or mesh.size("model") > 1)


def model_parallel(mesh):
    """``mesh`` where its model axis is above 1, else None (no TP)."""
    return mesh if sharded(mesh) and mesh.size("model") > 1 else None


def named_leaves(tree, prefix=""):
    """(``state_dict`` key, leaf) pairs of a nested dict/list tree: a list's
    entries are keyed ``0``, ``1``, ... as ``convert.params_from_jax`` does."""
    if isinstance(tree, dict):
        pairs = tree.items()
    elif isinstance(tree, (list, tuple)):
        pairs = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in pairs:
        yield from named_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def fused_blocks(key: str, spec, act: str) -> int:
    """2 for a swiglu projection fused as ``[gate | up]`` on its last dim
    (a dense FFN's ``wi``, the sLSTM block's ``ffn_wi``), else 1.
    (:func:`param_layout` splits the dim whole where a block does not
    divide, as the sLSTM's 2 x 85 at smoke width on model 2.)"""
    name = key.rsplit(".", 1)[-1]
    fused = (name == "ffn_wi" or (name == "wi" and act == "swiglu"))
    return 2 if fused and spec.logical[-1] == "mlp" else 1


def param_layout(specs, act: str, mesh) -> Dict[str, Placement]:
    """Each parameter's :class:`Placement` by ``state_dict`` key: the rules'
    spec fitted to the shape (``fit_pspec``) on a sharded mesh, every dim
    whole otherwise."""
    from .rules import PARAM_RULES, fit_pspec  # the rules import the models, which import this

    out = {}
    # Every axis's size, also of one that the mesh does not name.
    sizes = SimpleNamespace(shape={a: mesh.size(a) for a in SHARD_AXES}) if sharded(mesh) else None
    for key, spec in named_leaves(specs):
        if sharded(mesh):
            logical = tuple(None if n is None else PARAM_RULES[n] for n in spec.logical)
            ps = fit_pspec(logical, spec.shape, sizes)
        else:
            ps = (None,) * len(spec.shape)
        pl = Placement(ps, fused_blocks(key, spec, act))
        split = math.prod(mesh.size(a) for a in pl.axes(len(ps) - 1)) if ps else 1
        if pl.blocks > 1 and spec.shape[-1] % (pl.blocks * split):
            pl = Placement(ps)  # a block that does not split: the whole dim splits
        out[key] = pl
    return out


def whole_shape(shape, pl: Placement, mesh) -> Tuple[int, ...]:
    """The whole tensor's shape from a block's."""
    return tuple(n * math.prod(mesh.size(a) for a in pl.axes(d)) for d, n in enumerate(shape))


def _index(axes, mesh) -> Tuple[int, int]:
    """The rank's row-major index over ``axes`` and their joint size."""
    c = 0
    for a in axes:
        c = c * mesh.size(a) + mesh.coords.get(a, 0)
    return c, math.prod(mesh.size(a) for a in axes)


def shard(t: torch.Tensor, pl: Placement, mesh, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (a new contiguous tensor),
    cast to ``dtype`` where one is given: the block is cast, not the whole."""
    for d in range(t.ndim):
        axes = pl.axes(d)
        if not axes:
            continue
        c, n = _index(axes, mesh)
        b = pl.blocks_of(d)
        t = t.unflatten(d, (b, n, t.shape[d] // (b * n))).narrow(d + 1, c, 1).flatten(d, d + 2)
    t = t.contiguous()
    return t.clone() if dtype is None else t.to(dtype, copy=True)


def _gather(t: torch.Tensor, dim: int, axis, mesh, blocks: int = 1) -> torch.Tensor:
    """All-gather ``t`` along ``dim`` over ``axis`` (a name, or a tuple of
    them gathered row-major); with ``blocks`` the pieces interleave block by
    block."""
    a = mesh.group_size(mesh.group_name(axis))
    if a == 1:
        return t
    moved = t.movedim(dim, 0).contiguous()
    full = mesh.all_gather(moved.view(-1), axis).view(a, *moved.shape)
    if blocks > 1:
        full = full.unflatten(1, (blocks, -1)).transpose(0, 1)
    return full.reshape(a * moved.shape[0], *moved.shape[1:]).movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, axis: str, mesh, blocks: int = 1
                    ) -> torch.Tensor:
    """Sum ``t`` over ``axis`` and keep this rank's piece along ``dim`` (the
    inverse layout of :func:`_gather`)."""
    a = mesh.size(axis)
    if a == 1:
        return t
    moved = t.movedim(dim, 0)
    rest = moved.shape[1:]
    if blocks > 1:
        moved = moved.unflatten(0, (blocks, a, -1)).transpose(0, 1)
    flat = moved.reshape(-1).contiguous()
    return mesh.reduce_scatter(flat, axis).view(-1, *rest).movedim(0, dim)


def gather(t: torch.Tensor, pl: Placement, mesh, axes=SHARD_AXES) -> torch.Tensor:
    """The tensor whole over ``axes`` from this rank's block (every rank of
    those axes' groups must call it); no autograd.  A dim split over a tuple
    of axes gathers its last axis first (the split is row-major)."""
    for d in range(t.ndim):
        for axis in reversed(pl.axes(d)):
            if axis in axes:
                t = _gather(t, d, axis, mesh, pl.blocks_of(d))
    return t


def shard_tree(full: Dict[str, torch.Tensor], layout: Dict[str, Placement], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's block of each whole tensor of a flat ``state_dict``-keyed
    tree (keys that ``layout`` lacks, like the step count, stay as they are)."""
    return {k: shard(t, layout[k], mesh) if k in layout else t for k, t in full.items()}


@torch.no_grad()
def gather_tree(shards: Dict[str, torch.Tensor], layout: Dict[str, Placement], mesh
                ) -> Dict[str, torch.Tensor]:
    """The whole tensors back from every rank's blocks (every rank calls it);
    for checkpoints and tests."""
    return {k: gather(t, layout[k], mesh) if k in layout else t for k, t in shards.items()}


# ------------------------------------------------------------- autograd --
class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, blocks):
        ctx.dim, ctx.mesh, ctx.blocks, ctx.dtype = dim, mesh, blocks, t.dtype
        return _gather(t, dim, "data", mesh, blocks)

    @staticmethod
    def backward(ctx, g):
        rs = _reduce_scatter(g.float(), ctx.dim, "data", ctx.mesh, ctx.blocks)
        return rs.to(ctx.dtype), None, None, None


def gather_data(t: torch.Tensor, dim: int, mesh, blocks: int = 1) -> torch.Tensor:
    """``t`` whole along ``dim`` over ``data`` (an all-gather), its gradient
    reduce-scattered over ``data`` in fp32 (``mesh`` None or data 1: ``t``)."""
    if mesh is None or mesh.size("data") == 1:
        return t
    return _GatherOnUse.apply(t, dim, mesh, blocks)


def gather_on_use(t: torch.Tensor, pl: Placement, mesh, stacked: bool = False
                  ) -> torch.Tensor:
    """``t`` (a block of a parameter; with ``stacked`` one layer's slice of a
    stacked one) whole over ``data``: an all-gather in the forward, an fp32
    reduce-scatter of the gradient in the backward."""
    d = pl.dim_of("data")
    if d is None or mesh is None or mesh.size("data") == 1:
        return t
    return gather_data(t, d - int(stacked), mesh, pl.blocks_of(d))


def _all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    out = x.contiguous().clone()
    mesh.all_reduce(out.view(-1), "model", op)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is, its gradient all-reduced over
    ``model``; ``tp`` None (no model axis): ``x``."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """Megatron's *g*: the sum of ``x`` over ``model``, its gradient as it
    is; ``tp`` None: ``x``."""
    return x if tp is None else _ReduceFromModel.apply(x, tp)


class _ReduceScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, blocks):
        ctx.dim, ctx.mesh, ctx.blocks = dim, mesh, blocks
        return _reduce_scatter(x, dim, "model", mesh, blocks)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, "model", ctx.mesh, ctx.blocks), None, None, None


class _AllGatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather(x, dim, "model", mesh)

    @staticmethod
    def backward(ctx, g):
        # Each rank's work read the whole tensor: its gradient is the sum of
        # theirs, of which the rank keeps its own slice.
        return _reduce_scatter(g, ctx.dim, "model", ctx.mesh), None, None


class _AllReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _SliceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, blocks):
        ctx.dim, ctx.mesh, ctx.blocks = dim, mesh, blocks
        M, m = mesh.size("model"), mesh.coords["model"]
        n = t.shape[dim] // (blocks * M)
        return t.unflatten(dim, (blocks, M, n)).narrow(dim + 1, m, 1).flatten(
            dim, dim + 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, "model", ctx.mesh, ctx.blocks), None, None, None


def reduce_scatter_model(x: torch.Tensor, tp, dim: int = -1, blocks: int = 1) -> torch.Tensor:
    """The sum of the partials ``x`` over ``model``, this rank's ``1/M`` of
    it along ``dim`` (with ``blocks``: of each of the dim's ``blocks``
    blocks); the gradient all-gathered.  ``tp`` None: ``x``."""
    return x if tp is None else _ReduceScatterModel.apply(x, dim % x.ndim, tp, blocks)


def all_gather_model(x: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` along ``dim``, in model order; the gradient
    summed over ``model`` and this rank's slice kept.  ``tp`` None: ``x``."""
    return x if tp is None else _AllGatherModel.apply(x, dim % x.ndim, tp)


def all_reduce_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum of ``x`` over ``model``, its gradient summed over ``model``
    too (the sum feeds work that differs between model ranks).  ``tp``
    None: ``x``."""
    return x if tp is None else _AllReduceModel.apply(x, tp)


def slice_model(t: torch.Tensor, tp, dim: int = 0, blocks: int = 1) -> torch.Tensor:
    """This rank's ``1/M`` along ``dim`` (of each of its ``blocks`` blocks) of
    ``t``, which every model rank holds whole; the gradient all-gathered,
    so that every model rank's whole gradient is the same.  ``tp`` None:
    ``t``."""
    return t if tp is None else _SliceModel.apply(t, dim % t.ndim, tp, blocks)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return mesh.all_to_all(t.contiguous().view(-1), axes).view(t.shape)

    @staticmethod
    def backward(ctx, g):
        # Piece i of the output came from rank i: its gradient goes back there,
        # which is the same exchange.
        return ctx.mesh.all_to_all(g.contiguous().view(-1), ctx.axes).view(g.shape), None, None


def all_to_all(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``t`` ``[a, ...]`` exchanged over the group of ``axes`` (``a`` ranks):
    piece ``i`` of dim 0 goes to the group's rank ``i``, and piece ``i`` of
    the result came from it."""
    return _AllToAll.apply(t, axes, mesh)


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, t.shape[dim]
        return _gather(t, dim, "model", mesh)

    @staticmethod
    def backward(ctx, g):
        # The gathered tensor feeds what every model rank computes alike, so
        # the gradient that arrives is the same on every model rank: each
        # keeps the gradient of its own slice, and nothing is summed.
        m = ctx.mesh.coords["model"]
        return g.narrow(ctx.dim, m * ctx.n, ctx.n).contiguous(), None, None


def gather_slices(t: torch.Tensor, tp, dim: int = 1) -> torch.Tensor:
    """Every model rank's slice of ``t`` along ``dim``, in model order (``tp``
    None: ``t``); the backward keeps the rank's own slice of the gradient."""
    return t if tp is None else _GatherSlices.apply(t, dim % t.ndim, tp)


def max_over_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The elementwise max of ``x`` over ``model`` (no gradient)."""
    return x if tp is None else _all_reduce(x.detach(), tp, "max")


def gather_model(x: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """``x`` whole along ``dim`` over ``model`` (no gradient): vocab-sharded
    logits for the argmax."""
    return x if tp is None else _gather(x.detach(), dim % x.ndim, "model", tp)


def row_rank(mesh, axes=ROWS) -> Tuple[int, int]:
    """(this rank's index among the ranks whose rows split over ``axes``,
    pod-major; their count)."""
    return _index(axes, mesh) if mesh is not None else (0, 1)


def gather_rows(x: torch.Tensor, mesh, axes: Tuple[str, ...] = ROWS) -> torch.Tensor:
    """Every row rank's rows of ``x`` (dim 0) over ``axes``, in their order
    (no gradient)."""
    return x if mesh is None else _gather(x.detach(), 0, tuple(axes), mesh)

