"""The train step over a mesh of data-parallel ranks, and the encoder's
serving step.

Port of ``repro/launch/steps.py``.  A train state mirrors the reference's
``{"params", "opt": {"step", "mu", "nu"}}`` (plus ``"ef"`` under int8
exchange), with the model's own parameters (and the moments) as flat dicts
under ``state_dict`` keys, updated in place.  Gradient accumulation follows
``_grad_fn``: each microbatch's gradients are taken on their own, cast to
fp32, summed in fp32 buffers and divided by the count, never accumulated in
the parameters' dtype.  The learning rate is the schedule at the step count
*before* the update, so the first update (lr 0 with warmup) moves only the
moments.

Each rank of a :class:`~repro_torch.launch.mesh.Mesh` runs the step on its
rows of the global batch (:func:`rank_rows`; every model rank of one data
coordinate takes the same rows).  With ``data`` or ``model`` above 1 a rank
holds only its blocks of the state (``sharding/shard.py``), the same blocks
in every pod: the model's backward reduce-scatters each gradient over
``data`` in fp32 as it leaves its FSDP gather (the reference's *cohort
election*: each rank leads a ``1/D`` fragment), the step divides the sums by
``D`` (a leaf whole on ``data`` is averaged over it), and the global norm is
taken over the pod's own ranks.  Over pods only those blocks cross the slow
fabric (:func:`flat_pod_mean`, ``cohort.pod_sync_grads``); the pod modes
(``RunConfig.sync_mode``) are the reference's, where a pod dim is a rank's
``pod`` coordinate:

  flat  — the paper-baseline: rows split over (pod × data) jointly, a MoE
          layer's groups over them too (:func:`step_rows`); each block's
          gradient all-reduced over ``pod`` in its dtype, leaf by leaf
          (:func:`flat_pod_mean`).
  sync  — the cohort schedule: a MoE layer's groups over a pod's rows; the
          blocks' gradients all-reduced over ``pod`` in one fp32 bucket;
          numerically ``flat`` (without MoE), and with FSDP the same bytes.
          With ``compress_int8`` the pod hop carries int8 with error
          feedback, one scale per leaf per pod (``cohort.int8_block_mean``).
  local — budgeted: per-pod parameters and optimizer state, gradients
          averaged inside the pod only, and the pods' *parameter blocks*
          (not the moments) averaged after every ``sync_budget``-th update.

With one pod every mode is ``flat``; a mesh of one rank runs the
one-device step, with no collective.  Loss and metrics are averaged over
the rows' ranks, the optimizer's over pods (``local``) as the reference's
``vmap`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import RunConfig, ShapeConfig
from ..core.cohort import (SyncConfig, bucket_mean, flat_all_reduce, pod_average_params,
                           pod_sync_grads)
from ..models import Model, rank_inputs
from ..models.moe import Rows
from ..optim import AdamWState, adamw_init, adamw_update, cosine_schedule, global_norm
from ..sharding.shard import (ROWS, gather_model, gather_rows, gather_tree, shard_tree,
                              sharded, whole_shape)
from .mesh import Mesh


def _one_rank(model: Model) -> Mesh:
    dev = next(model.parameters()).device
    return Mesh(axes=("data",), shape={"data": 1}, coords={"data": 0}, device=dev)


def pod_mode(run: RunConfig, mesh: Mesh) -> str:
    """The reference's mode for ``run`` on ``mesh``: ``run.sync_mode`` with
    more than one pod, else ``flat``."""
    mode = run.sync_mode if mesh.size("pod") > 1 else "flat"
    mode = "flat" if mode == "none" else mode
    if mode not in ("flat", "sync", "local"):
        raise ValueError(f"sync_mode {run.sync_mode!r}")
    return mode


def step_rows(mode: str, mesh: Mesh) -> Rows:
    """The ranks whose rows make up one microbatch of a step in ``mode``, as
    the reference lays them: ``(pod, data)`` in ``flat`` (its ``_gf_axes``),
    a pod's ``data`` ranks in ``sync`` and ``local``, whose ``vmap`` over
    pods routes each pod's rows alone.  A MoE layer's groups lie over them
    (``models/moe.py``)."""
    return Rows(mesh, ROWS if mode == "flat" else ("data",))


def rank_rows(batch: Dict[str, torch.Tensor], mesh: Mesh, mode: str,
              microbatches: int) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch, as the reference lays them out:
    in ``sync`` and ``local`` pod ``p`` takes rows ``p·B/P …`` (``_pod_split``)
    and data rank ``d`` the ``d``-th of each microbatch's share of those; in
    ``flat`` rank ``p·D + d`` takes that share of each microbatch of the whole
    batch.  So the rank's own microbatches are its shares of the reference's.
    The model coordinate takes no part: model ranks share their rows."""
    if mesh.world_size == 1:
        return batch
    P, D = mesh.size("pod"), mesh.size("data")
    p, d = mesh.coords.get("pod", 0), mesh.coords.get("data", 0)
    outer, inner, o, i = (1, P * D, 0, p * D + d) if mode == "flat" else (P, D, p, d)
    m = max(microbatches, 1)
    rows = next(iter(batch.values())).shape[0]
    if rows % (outer * m * inner):
        raise ValueError(f"a batch of {rows} rows does not split over {outer} x {inner} "
                         f"ranks in {m} microbatches")
    per = rows // (outer * m * inner)
    return {k: v.reshape(outer, m, inner, per, *v.shape[1:])[o, :, i].reshape(
        m * per, *v.shape[1:]) for k, v in batch.items()}


def init_train_state(model: Model, run: RunConfig, mesh: Optional[Mesh] = None
                     ) -> Dict[str, Any]:
    """The train state over ``model``'s parameters (the tensors themselves,
    not copies) and zeroed moments in ``run.optimizer_state_dtype``; under
    int8 ``sync`` over pods also ``ef``, fp32 zeros (the error feedback)."""
    params = dict(model.named_parameters())
    opt = adamw_init(params, getattr(torch, run.optimizer_state_dtype))
    state = {"params": params, "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu}}
    if mesh is not None and pod_mode(run, mesh) == "sync" and run.compress_int8:
        state["ef"] = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for k, p in params.items()}
    return state


def _pod_groups(run: RunConfig, mesh: Mesh) -> Tuple[str, ...]:
    """The state's top-level groups that carry a leading pod dim in the
    reference's layout (``train_state_specs``): all in ``local`` mode,
    ``ef`` under int8 ``sync``."""
    if mesh.size("pod") == 1:
        return ()
    return ("params", "opt") if pod_mode(run, mesh) == "local" else ("ef",)


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _by_leaf(state: Dict[str, Any], fn) -> Dict[str, Any]:
    """``fn(leaves)`` on each flat tree of sharded leaves of a train state
    (``params``, ``mu``, ``nu``, and ``ef`` where it has one); the step
    count as it is."""
    opt = state["opt"]
    out = {"params": fn(state["params"]),
           "opt": {"step": opt["step"], "mu": fn(opt["mu"]), "nu": fn(opt["nu"])}}
    if "ef" in state:
        out["ef"] = fn(state["ef"])
    return out


@torch.no_grad()
def checkpoint_tree(state: Dict[str, Any], run: RunConfig, mesh: Mesh,
                    layout=None) -> Dict[str, Any]:
    """``state`` in the JAX package's checkpoint layout
    (``train_state_specs``): on a sharded mesh every tensor whole over
    ``(data, model)`` (``layout``: the model's, ``sharding.shard``; every
    rank must call it), then over pods the groups of :func:`_pod_groups`
    stacked over the pod group into a leading pod dim (every rank of the pod
    group that holds rank 0, data and model coordinates 0, must call it;
    other ranks get the rest back).  The gathers count in a traffic record
    of their own, not the steps'."""
    groups = _pod_groups(run, mesh)
    whole = layout is not None and sharded(mesh)
    lead = mesh.coords.get("data", 0) == 0 and mesh.coords.get("model", 0) == 0
    if not whole and not (groups and lead):
        return state
    P, traffic = mesh.size("pod"), mesh.traffic
    mesh.traffic = type(traffic)()
    try:
        if whole:
            state = _by_leaf(state, lambda tree: gather_tree(tree, layout, mesh))
        if groups and lead:
            stack = lambda t: mesh.all_gather(t.reshape(-1), "pod").view(P, *t.shape)
            state = {k: _map(v, stack) if k in groups else v for k, v in state.items()}
        return state
    finally:
        mesh.traffic = traffic


def checkpoint_like(state: Dict[str, Any], run: RunConfig, mesh: Mesh,
                    layout=None) -> Dict[str, Any]:
    """The shapes of :func:`checkpoint_tree` (``meta`` tensors), for
    ``load_checkpoint``."""
    if layout is not None and sharded(mesh):
        state = _by_leaf(state, lambda tree: {
            k: torch.empty(whole_shape(t.shape, layout[k], mesh), dtype=t.dtype, device="meta")
            for k, t in tree.items()})
    groups, P = _pod_groups(run, mesh), mesh.size("pod")
    pod_dim = lambda t: torch.empty((P, *t.shape), dtype=t.dtype, device="meta")
    return {k: _map(v, pod_dim) if k in groups else v for k, v in state.items()}


def pod_slice(tree: Dict[str, Any], run: RunConfig, mesh: Mesh,
              layout=None) -> Dict[str, Any]:
    """This rank's slice of a tree in the checkpoint layout: its pod's, and
    on a sharded mesh its blocks of each whole tensor (``layout``: the
    model's).  A checkpoint of any mesh of as many pods loads on any other
    this way."""
    groups, p = _pod_groups(run, mesh), mesh.coords.get("pod", 0)
    tree = {k: _map(v, lambda t: t[p]) if k in groups else v for k, v in tree.items()}
    if layout is not None and sharded(mesh):
        tree = _by_leaf(tree, lambda t: shard_tree(t, layout, mesh))
    return tree


@torch.no_grad()
def restore_train_state(state: Dict[str, Any], restored: Dict[str, Any]) -> None:
    """Copy a restored (or converted) tree into ``state`` in place: every
    tensor keeps its device and dtype (``ef`` too, where ``state`` has it);
    the step count is replaced."""
    for group, live in (("params", state["params"]),
                        ("mu", state["opt"]["mu"]), ("nu", state["opt"]["nu"])):
        new = restored["params"] if group == "params" else restored["opt"][group]
        if set(new) != set(live):
            raise KeyError(f"{group}: keys differ: {sorted(set(new) ^ set(live))}")
        for key, t in live.items():
            t.copy_(new[key])
    if "ef" in state:
        for key, t in state["ef"].items():
            t.copy_(restored["ef"][key])
    step = state["opt"]["step"]
    state["opt"]["step"] = torch.as_tensor(restored["opt"]["step"]).to(step.device, step.dtype)


def grad_fn(model: Model, microbatches: int = 1, rows: Optional[Rows] = None) -> Callable:
    """``fn(batch) -> (loss, metrics, grads)``, the reference's ``_grad_fn``:
    with ``microbatches > 1`` each slice of the batch rows gets its own
    backward, its gradients are summed in fp32 buffers and divided by the
    count (as are loss and metrics).  ``grads`` maps every parameter's
    ``state_dict`` key to a tensor (zeros where the loss does not read the
    parameter), in the parameters' dtype when there is one microbatch.
    ``rows``: the ranks whose rows make up a microbatch (``Model.loss``)."""
    names = [name for name, _ in model.named_parameters()]
    tensors = [p for _, p in model.named_parameters()]
    n = microbatches

    def value_and_grad(batch):
        loss, metrics = model.loss(batch, rows)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tensors, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def accumulated(batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into {n} microbatches")
        size = rows // n
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tensors]
        for i in range(n):
            l, m, g = value_and_grad({k: v[i * size:(i + 1) * size] for k, v in batch.items()})
            for acc, gi in zip(gacc, g):
                acc.add_(gi.float())
            del g
            lsum, msum = (l, m) if i == 0 else (lsum + l, {k: msum[k] + m[k] for k in m})
        return lsum / n, {k: v / n for k, v in msum.items()}, [g.div_(n) for g in gacc]

    def fn(batch):
        loss, metrics, grads = (value_and_grad if n <= 1 else accumulated)(batch)
        return loss, metrics, dict(zip(names, grads))

    return fn


def build_train_step(model: Model, run: RunConfig, mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` on this rank of ``mesh``
    (default: one rank on the model's device): the rank's rows of the global
    ``batch`` (:func:`rank_rows`), loss and gradients over
    ``run.microbatches`` slices of them (:func:`grad_fn`), their mean over
    ``data`` (:func:`data_mean`) and the exchange over ``pod`` of
    ``run.sync_mode`` (:func:`flat_pod_mean` in ``flat`` mode, else
    ``cohort.pod_sync_grads``), then one AdamW update of ``state`` in place
    (in ``local`` mode, then the budget's parameter average over ``pod``).
    ``metrics`` holds 0-d tensors (``ce``, ``loss``, ``grad_norm``), so a
    step on one rank never waits on the device."""
    mesh = mesh or _one_rank(model)
    if sharded(mesh) and model.mesh is not mesh:
        raise ValueError(f"the model holds no blocks of mesh {mesh.shape}: build it there")
    mode = pod_mode(run, mesh)
    grads_of = grad_fn(model, run.microbatches, step_rows(mode, mesh))
    P = mesh.size("pod")
    rows = P * mesh.size("data")  # ranks with rows of their own
    sync = SyncConfig(mode, run.sync_budget, run.compress_int8)
    shards = model.mesh is not None
    replicas = {k: pl.replicas(mesh) for k, pl in model.layout.items()} if shards else None
    norm_sum = lambda t: mesh.all_reduce(t, ("data", "model"))  # the pod's own ranks

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
        loss, metrics, grads = grads_of(rank_rows(batch, mesh, mode, run.microbatches))
        grads = data_mean(grads, model.layout, mesh)
        if mode == "flat":
            grads = flat_pod_mean(grads, mesh)
        else:
            grads, _ = pod_sync_grads(grads, sync, mesh, state.get("ef"))
        gnorm = global_norm(grads, replicas, norm_sum) if shards else None
        opt = AdamWState(state["opt"]["step"], state["opt"]["mu"], state["opt"]["nu"])
        before = opt.step
        lr = cosine_schedule(opt.step, peak_lr=run.learning_rate,
                             warmup=run.warmup_steps, total=run.total_steps)
        opt, om = adamw_update(state["params"], grads, opt, lr,
                               weight_decay=run.weight_decay, grad_clip=run.grad_clip,
                               gnorm=gnorm)
        del grads
        new_state = {"params": state["params"],
                     "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu}}
        if "ef" in state:
            new_state["ef"] = state["ef"]
        metrics = {**metrics, "loss": loss}
        if rows > 1:
            # Loss and metrics: the mean over every rank's rows (model ranks
            # share theirs); the optimizer's differ between pods only in
            # local mode.
            vec = mesh.all_reduce(torch.stack(list(metrics.values())).float(), ("pod", "data"))
            metrics = dict(zip(metrics, (vec / rows).unbind()))
        if P > 1 and mode == "local":
            vec = mesh.all_reduce(torch.stack(list(om.values())).float(), "pod")
            om = dict(zip(om, (vec / P).unbind()))
            pod_average_params(state["params"], sync, mesh, int(before))
        loss = metrics.pop("loss")
        metrics.update(om)
        metrics["loss"] = loss
        return new_state, metrics

    return step


def flat_pod_mean(grads: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``flat`` mode's exchange over ``pod``: every rank's gradient blocks
    (the pod's mean already) all-reduced leaf by leaf in their dtype and
    divided by ``P``.  With FSDP it moves the bytes of ``sync``'s bucket; the
    two differ only in bucketing and dtype."""
    P = mesh.size("pod")
    if P == 1:
        return grads
    # In place: a gradient that leaves its FSDP gather may be a permuted view.
    grads = {k: g.contiguous() for k, g in grads.items()}
    return {k: g.div_(P) for k, g in flat_all_reduce(grads, mesh, ("pod",)).items()}


def data_mean(grads: Dict[str, torch.Tensor], layout, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mean over ``data`` of a sharded model's gradients: a leaf split on
    ``data`` arrives summed over it (the reduce-scatter as it leaves its
    FSDP gather) and is divided by ``D``; a leaf whole on ``data`` (where
    ``fit_pspec`` left the dim) is averaged over it through one fp32 bucket.
    A leaf whole on ``model`` has the same gradient on every model rank
    (*f* sits after each norm)."""
    D = mesh.size("data")
    if D == 1:
        return grads
    whole = {k: g for k, g in grads.items() if layout[k].dim_of("data") is None}
    out = {k: g.div(D) for k, g in grads.items() if k not in whole}
    if whole:
        out.update(bucket_mean(whole, mesh, "data"))
    return {k: out[k] for k in grads}


def build_encode_step(model: Model, mesh: Optional[Mesh] = None) -> Callable:
    """``encode(batch) -> logits [B, T, V]`` for an encoder (hubert's
    "prefill"): the training-mode forward over every position, then the
    logits, under ``torch.inference_mode``; the reference's
    ``build_encode_step``.  On a ``mesh`` of several ranks (on a sharded one,
    the mesh the model was built on) each rank encodes its ``(pod, data)``
    rows of the global ``batch`` (:func:`models.rank_inputs`) and returns the
    whole logits, gathered over ``model`` and the rows."""
    if sharded(mesh) and mesh is not model.mesh:
        raise ValueError(f"the model holds no blocks of mesh {mesh.shape}: build it there")

    @torch.inference_mode()
    def encode(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        head = model._head()
        if mesh is not None:
            rows = next(iter(batch.values())).shape[0]
            batch = rank_inputs(batch, model.cfg, ShapeConfig("encode", 0, rows, "prefill"),
                                mesh)
        h, _ = model.forward(batch, head, Rows(mesh) if mesh is not None else None)
        return gather_rows(gather_model(model._logits(h, head), model.vocab_tp), mesh)

    return encode
