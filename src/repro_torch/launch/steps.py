"""The train step and the encoder's serving step on one device.

Port of the single-device (``flat``) half of ``repro/launch/steps.py``: a
train state mirrors the reference's ``{"params", "opt": {"step", "mu",
"nu"}}``, with the model's own parameters (and the moments) as flat dicts
under ``state_dict`` keys, updated in place.  Gradient accumulation follows
``_grad_fn``: each microbatch's gradients are taken on their own, cast to
fp32, summed in fp32 buffers and divided by the count, never accumulated in
the parameters' dtype.  The learning rate is the schedule at the step count
*before* the update, so the first update (lr 0 with warmup) moves only the
moments.  The pod-axis modes (``sync``, ``local``, int8 exchange) wait for
the port's multi-GPU work.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import RunConfig
from ..models import Model
from ..optim import AdamWState, adamw_init, adamw_update, cosine_schedule

def _check_one_pod(run: RunConfig, npods: int) -> None:
    if npods != 1:
        raise NotImplementedError(
            f"the port trains on one device; sync_mode={run.sync_mode!r} "
            f"(compress_int8={run.compress_int8}) over {npods} pods waits for "
            "its multi-GPU port")


def init_train_state(model: Model, run: RunConfig, npods: int = 1) -> Dict[str, Any]:
    """The train state over ``model``'s parameters (the tensors themselves,
    not copies) and zeroed moments in ``run.optimizer_state_dtype``."""
    _check_one_pod(run, npods)
    params = dict(model.named_parameters())
    opt = adamw_init(params, getattr(torch, run.optimizer_state_dtype))
    return {"params": params, "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu}}


@torch.no_grad()
def restore_train_state(state: Dict[str, Any], restored: Dict[str, Any]) -> None:
    """Copy a restored (or converted) tree into ``state`` in place: every
    tensor keeps its device and dtype; the step count is replaced."""
    for group, live in (("params", state["params"]),
                        ("mu", state["opt"]["mu"]), ("nu", state["opt"]["nu"])):
        new = restored["params"] if group == "params" else restored["opt"][group]
        if set(new) != set(live):
            raise KeyError(f"{group}: keys differ: {sorted(set(new) ^ set(live))}")
        for key, t in live.items():
            t.copy_(new[key])
    step = state["opt"]["step"]
    state["opt"]["step"] = torch.as_tensor(restored["opt"]["step"]).to(step.device, step.dtype)


def grad_fn(model: Model, microbatches: int = 1) -> Callable:
    """``fn(batch) -> (loss, metrics, grads)``, the reference's ``_grad_fn``:
    with ``microbatches > 1`` each slice of the batch rows gets its own
    backward, its gradients are summed in fp32 buffers and divided by the
    count (as are loss and metrics).  ``grads`` maps every parameter's
    ``state_dict`` key to a tensor (zeros where the loss does not read the
    parameter), in the parameters' dtype when there is one microbatch."""
    names = [name for name, _ in model.named_parameters()]
    tensors = [p for _, p in model.named_parameters()]
    n = microbatches

    def value_and_grad(batch):
        loss, metrics = model.loss(batch)
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


def build_train_step(model: Model, run: RunConfig, npods: int = 1) -> Callable:
    """``step(state, batch) -> (state, metrics)``: loss and gradients over
    ``run.microbatches`` slices of the batch rows (:func:`grad_fn`), then one
    AdamW update of ``state`` in place.  ``metrics`` holds 0-d tensors
    (``ce``, ``loss``, ``grad_norm``), so a step never waits on the device."""
    _check_one_pod(run, npods)
    grads_of = grad_fn(model, run.microbatches)

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
        loss, metrics, grads = grads_of(batch)
        opt = AdamWState(state["opt"]["step"], state["opt"]["mu"], state["opt"]["nu"])
        lr = cosine_schedule(opt.step, peak_lr=run.learning_rate,
                             warmup=run.warmup_steps, total=run.total_steps)
        opt, om = adamw_update(state["params"], grads, opt, lr,
                               weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        del grads
        new_state = {"params": state["params"],
                     "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu}}
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return new_state, metrics

    return step


def build_encode_step(model: Model) -> Callable:
    """``encode(batch) -> logits [B, T, V]`` for an encoder (hubert's
    "prefill"): the training-mode forward over every position, then the
    logits, under ``torch.inference_mode``; the reference's
    ``build_encode_step``."""

    @torch.inference_mode()
    def encode(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h, _ = model.forward(batch)
        return model._logits(h)

    return encode
