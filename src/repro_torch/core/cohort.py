"""Cohort-scheduled collectives — the paper's technique on a GPU cluster.

Port of ``repro/core/cohort.py`` over ``torch.distributed``.  The paper
synchronises two asymmetric classes by (1) electing a leader inside each
class with a mechanism optimal for that class, (2) running a minimal
2-party protocol between leaders, and (3) bounding consecutive same-class
hand-offs with a *budget*.  Across GPUs the classes are the two fabrics,
inside a pod (the ``data`` axis: NVLink, "local") and between pods (the
``pod`` axis: the network, "remote"), and the technique becomes a
hierarchical gradient exchange:

1. **cohort election** — a reduce-scatter over ``data``: each rank becomes
   leader ("queue head") of a ``1/|data|`` fragment of the gradient;
2. **global protocol** — the fragment's all-reduce over ``pod`` only (2 pods
   ⇔ Peterson's two parties); only leaders touch the slow fabric, and only
   with their fragment;
3. **hand-off** — an all-gather over ``data`` hands the reduced fragment
   back (the MCS lock pass: a local write, never a remote one);
4. **budget** — ``sync_budget`` local steps between pod exchanges
   (``budget=1`` ⇔ exact synchronous data parallelism; ``budget>1`` ⇔
   bounded-staleness local sync).

Trees are dicts of tensors (a ``state_dict``'s keys).  Every function takes
the rank's :class:`repro_torch.launch.mesh.Mesh`, whose collectives count
the bytes each call puts on each group (``mesh.traffic``): the analog of
what the reference's ``launch/hloparse.py`` read off compiled HLO.

The reference's ``wrap_step_with_pod_sync`` lifts a single-pod step to the
multi-pod mesh with ``shard_map``; a rank's step is already per pod here,
so it has no analog (``launch/steps.py`` calls these functions itself).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

Tree = Dict[str, torch.Tensor]
# (key, shape, dtype, offset, numel) of each leaf in a bucket
Layout = List[Tuple[str, torch.Size, torch.dtype, int, int]]


# --------------------------------------------------------------------------
# Standalone primitive: bucketed cohort all-reduce
# --------------------------------------------------------------------------
def _layout(tree: Tree) -> Tuple[Layout, int]:
    """Each leaf's place in a bucket of the leaves end to end, and the total."""
    layout: Layout = []
    off = 0
    for key, t in tree.items():
        layout.append((key, t.shape, t.dtype, off, t.numel()))
        off += t.numel()
    return layout, off


def _flatten_bucket(tree: Tree, multiple: int = 1) -> Tuple[torch.Tensor, Layout]:
    """One fp32 bucket (DDP-style) of every leaf, zero-padded to a multiple
    of ``multiple``, and its layout."""
    layout, off = _layout(tree)
    some = next(iter(tree.values()))
    flat = torch.zeros(off + (-off) % multiple, dtype=torch.float32, device=some.device)
    for key, _, _, o, n in layout:
        flat[o:o + n].copy_(tree[key].reshape(-1))
    return flat, layout


def _unflatten_bucket(flat: torch.Tensor, layout: Layout) -> Tree:
    """Each leaf of ``layout`` from ``flat``, in its own shape and dtype (a
    view of ``flat`` for fp32 leaves)."""
    return {key: flat[o:o + n].view(shape).to(dtype) for key, shape, dtype, o, n in layout}


def cohort_all_reduce(tree: Tree, mesh, cohort_axis: str = "data",
                      global_axis: str = "pod", divisor: int = 1) -> Tree:
    """Hierarchical all-reduce (sum) of a tree over both axes: reduce-scatter
    over ``cohort_axis``, all-reduce of the fragment over ``global_axis``,
    all-gather over ``cohort_axis``.  Numerically a sum over both axes (in
    fp32), as :func:`flat_all_reduce`; divided by ``divisor`` in fp32 before
    each leaf is cast back to its dtype.  The bucket is padded to a multiple
    of the cohort's size."""
    flat, layout = _flatten_bucket(tree, mesh.size(cohort_axis))
    frag = mesh.reduce_scatter(flat, cohort_axis)
    del flat
    mesh.all_reduce(frag, global_axis)      # leaders' 2-party exchange
    if divisor != 1:
        frag.div_(divisor)
    return _unflatten_bucket(mesh.all_gather(frag, cohort_axis), layout)


def flat_all_reduce(tree: Tree, mesh, axes: Sequence[str] = ("pod", "data")) -> Tree:
    """The paper-baseline: one flat all-reduce (sum) of each leaf over both
    fabrics, in the leaf's dtype (the analogue of every process hammering
    the global word with rCAS).  ``tree``'s tensors are reduced in place."""
    for t in tree.values():
        mesh.all_reduce(t.view(-1), tuple(axes))
    return tree


def bucket_mean(tree: Tree, mesh, axis: str) -> Tree:
    """The mean of ``tree`` over one axis, through one fp32 bucket."""
    n = mesh.size(axis)
    if n == 1:
        return tree
    flat, layout = _flatten_bucket(tree)
    return _unflatten_bucket(mesh.all_reduce(flat, axis).div_(n), layout)


# --------------------------------------------------------------------------
# Trainer integration: pod-axis sync with budget + compression
# --------------------------------------------------------------------------
class SyncConfig(NamedTuple):
    """How the trainer crosses the slow fabric.

    mode:
      "none"     — single-pod / no pod axis: no-op.
      "sync"     — exact: average gradients over the pod axis every step.
      "local"    — budgeted: gradients stay inside the pod; parameters are
                   pod-averaged every ``budget`` steps (bounded staleness,
                   straggler mitigation; exactness is traded for quiet on the
                   slow fabric).
    compress_int8: apply int8 error-feedback compression to the pod payload.
    budget: local steps between pod syncs (must be ≥ 1).
    """

    mode: str = "sync"
    budget: int = 1
    compress_int8: bool = False
    pod_axis: str = "pod"


def _ef_quantize(x: torch.Tensor, err: torch.Tensor, absmax: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 quantisation with error feedback. Returns (q, scale, new_err):
    ``y = x + err`` (fp32 for an fp32 ``err``), one fp32 scale over all of
    ``y`` (``absmax``: the largest ``|y|`` of the whole leaf, where ``x`` is
    a block of it), and ``y`` less its dequantisation in ``x``'s dtype."""
    y = x + err
    scale = torch.clamp(y.abs().max() if absmax is None else absmax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    deq = q.to(x.dtype) * scale.to(x.dtype)
    return q, scale, y - deq


@torch.no_grad()
def int8_block_mean(grads: Tree, ef: Tree, mesh, axis: str = "pod",
                    scale_axes: Tuple[str, ...] = ("data", "model")) -> Tree:
    """The mean over pods of every rank's gradient *blocks* (FSDP's and
    TP's, already averaged inside the pod), where the pod hop carries int8
    with error feedback: the reference's ``_int8_pod_mean``, whose leaves
    enter its ``shard_map`` whole over ``data`` and ``model`` and take one
    fp32 scale per leaf per pod.  So each block is quantised with its
    *leaf's* scale: the largest ``|g + ef|`` of the block, then a max over
    the pod's own ranks (``scale_axes``); a leaf that several ranks hold
    alike is quantised alike on each.  The int8 blocks and the scales are
    all-gathered over ``axis`` (``P·n`` int8 bytes for a rank of ``n``
    elements), and the dequantised blocks summed and divided by ``P`` in
    each leaf's dtype.  ``ef`` (one fp32 block a rank) is updated in place;
    ``grads`` is emptied, each leaf let go once it is quantised, and the sum
    is taken in slices of ``CHUNK_ELEMENTS``."""
    from ..launch.mesh import CHUNK_ELEMENTS  # the mesh module imports this package

    P = mesh.size(axis)
    layout, n = _layout(grads)
    some = next(iter(grads.values()))
    absmax = torch.stack([(grads[key].float() + ef[key]).abs().max()
                          for key, *_ in layout]).float()
    mesh.all_reduce(absmax, scale_axes, "max")
    q = torch.empty(n, dtype=torch.int8, device=some.device)
    scales = torch.empty(len(layout), dtype=torch.float32, device=some.device)
    for i, (key, _, _, o, size) in enumerate(layout):
        qi, scales[i], new_e = _ef_quantize(grads.pop(key), ef[key], absmax[i])
        q[o:o + size].copy_(qi.reshape(-1))
        ef[key].copy_(new_e)
        del qi, new_e
    qs = mesh.all_gather(q, axis).view(P, n)             # int8 on the slow fabric
    del q
    ss = mesh.all_gather(scales, axis).view(P, len(layout))
    out = {}
    for i, (key, shape, dtype, o, size) in enumerate(layout):
        leaf = torch.empty(size, dtype=dtype, device=some.device)
        for a in range(o, o + size, CHUNK_ELEMENTS):
            b = min(a + CHUNK_ELEMENTS, o + size)
            deq = qs[:, a:b].to(dtype) * ss[:, i:i + 1].to(dtype)
            leaf[a - o:b - o] = torch.sum(deq, dim=0) / P
        out[key] = leaf.view(shape)
    return out


def pod_sync_grads(grads: Tree, cfg: SyncConfig, mesh, ef_state: Optional[Tree] = None):
    """Cross-pod gradient exchange.  Returns (synced_grads, ef_state): in
    ``sync`` mode the mean over ``cfg.pod_axis`` of every rank's gradients
    (whole leaves, or FSDP's and TP's blocks), which the pod has averaged
    already, through one fp32 bucket (:func:`bucket_mean`), or with
    ``compress_int8`` in int8 with error feedback (:func:`int8_block_mean`,
    which empties ``grads`` and updates ``ef_state``, fp32 zeros when
    ``None``, in place); in any other mode ``grads`` as they are.  A ``pod``
    group joins the ranks that share their ``(data, model)`` coordinates,
    which hold the same blocks, so each rank sends only its own block over
    the slow fabric."""
    if cfg.mode != "sync":
        return grads, ef_state
    if not cfg.compress_int8:
        return bucket_mean(grads, mesh, cfg.pod_axis), ef_state
    if ef_state is None:
        ef_state = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                    for k, g in grads.items()}
    return int8_block_mean(grads, ef_state, mesh, cfg.pod_axis), ef_state


@torch.no_grad()
def pod_average_params(params: Tree, cfg: SyncConfig, mesh, step: int) -> bool:
    """Budgeted parameter averaging ("local" mode), in place: at the step
    count ``step`` before the update, every ``budget`` steps the pods
    reconcile (the paper's ``pReacquire`` — the slow fabric is served on a
    bound, never starved).  Returns whether they did."""
    if cfg.mode != "local" or step % cfg.budget != cfg.budget - 1:
        return False
    for key, p in bucket_mean(params, mesh, cfg.pod_axis).items():
        params[key].copy_(p)
    return True
