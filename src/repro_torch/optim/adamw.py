"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py``, rule for rule, and not ``torch.optim.AdamW``:
b2 0.95, eps 1e-8, the clip scale ``min(1, clip / max(gnorm, 1e-12))``,
moments stored in ``state_dtype`` with the arithmetic in fp32 and the result
cast back to each tensor's dtype, bias corrections from the incremented step,
and weight decay on every tensor whose *stored* shape has ``ndim >= 2``.  The
last rule reaches the stacked norm scales (``blocks.b{i}.ln1.scale`` is
``[n_scan, D]``) as it does in the reference, and not ``final_norm.scale``
(``[D]``), so the update runs on the stored stacked tensors, never on
per-layer slices.

Parameters and moments are dicts of tensors under one set of keys; unlike the
reference's pure function, the update writes them in place, so a training
step holds no second copy of either.  The step count is a 0-d int32 tensor,
and the learning rate may be a tensor: nothing here waits on the device.

The update and the global norm walk each tensor in slices of its flattened
storage of at most :data:`CHUNK_ELEMENTS` elements, so that no fp32
temporary holds a whole tensor: deepseek-v2's stacked routed experts
(``blocks.b0.ffn.wi``, 2.5 G elements at one MoE layer) would take 10 GB for
each.  The update is elementwise, so every element gets the bits it would
get in one piece; the norm's sum changes only in its order.

Over the shards of a mesh (``sharding/shard.py``) the same update runs on
each rank's blocks, which keep their ndim, so weight decay keeps its rule on
the *logical* ndim; the global norm sums each rank's squares, each leaf's
divided by the count of ranks that hold it (a norm scale replicated on
``model`` counts once), and all-reduces the sum before the root.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Tensors = Dict[str, torch.Tensor]

# The most elements of one tensor that the update and the norm take at once
# (2^26: 256 MB for each fp32 temporary).
CHUNK_ELEMENTS = 2 ** 26


class AdamWState(NamedTuple):
    step: torch.Tensor   # [] int32: updates taken
    mu: Tensors
    nu: Tensors


def _chunks(t: torch.Tensor):
    """Slices of ``t``'s flattened view, each at most CHUNK_ELEMENTS long."""
    return t.view(-1).split(CHUNK_ELEMENTS)


def global_norm(tensors: Tensors, replicas: Optional[Dict[str, int]] = None,
                all_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32.  Over shards:
    ``replicas`` maps each key to the count of ranks that hold each of its
    elements, and ``all_reduce`` sums a 1-element fp32 tensor over the ranks
    (in place)."""
    if replicas is None:
        return torch.sqrt(sum(torch.sum(torch.square(c.float()))
                              for t in tensors.values() for c in _chunks(t.contiguous())))
    local = sum(sum(torch.sum(torch.square(c.float())) for c in _chunks(t.contiguous()))
                / replicas[k] for k, t in tensors.items())
    return torch.sqrt(all_reduce(local.reshape(1)).reshape(()))


def adamw_init(params: Tensors, state_dtype=torch.float32) -> AdamWState:
    some = next(iter(params.values()))
    zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        mu={k: zeros(p) for k, p in params.items()},
        nu={k: zeros(p) for k, p in params.items()},
    )


@torch.no_grad()
def adamw_update(
    params: Tensors,
    grads: Tensors,
    state: AdamWState,
    lr: Union[float, torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    gnorm: Optional[torch.Tensor] = None,
) -> Tuple[AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, written into ``params``, ``state.mu`` and ``state.nu``;
    ``gnorm`` the gradients' global norm where the caller took it over
    shards (else :func:`global_norm` of ``grads``).
    Returns (the state with its step advanced, metrics with ``grad_norm``)."""
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if grad_clip else 1.0)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)
    for key, p in params.items():
        wd = weight_decay if p.ndim >= 2 else 0.0
        for pc, gc, m, v in zip(*map(_chunks, (p, grads[key].contiguous(), state.mu[key],
                                               state.nu[key]))):
            g = gc.float() * scale
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + eps)
            p32 = pc.float()
            pc.copy_(p32 - lr * (delta + wd * p32))
            m.copy_(m_new)
            v.copy_(v_new)
    return AdamWState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm}
