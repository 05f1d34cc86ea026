"""Load a JAX parameter tree, or a whole JAX train state, into the port.

The JAX and torch random streams differ, so parity runs start from one
JAX ``Model.init`` tree (or ``init_train_state``), handed over as numpy
arrays (``jax.device_get``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_tensor(x: Any) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes.bfloat16; bf16 → fp32 → bf16 is exact.
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested dict/list of arrays into a ``state_dict``: the JAX path
    ``["blocks"]["b0"]["attn"]["wq"]`` becomes ``"blocks.b0.attn.wq"``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: _to_tensor(tree)}
    out: Dict[str, torch.Tensor] = {}
    for key, val in items:
        out.update(params_from_jax(val, f"{prefix}.{key}" if prefix else str(key)))
    return out


def shard_params(params: Dict[str, torch.Tensor], model) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a whole tree (:func:`params_from_jax`'s) for
    ``model``'s mesh and layout, to load with ``model.load_state_dict``; the
    tree itself where the model is not sharded.  Every layout thus starts
    from one JAX init."""
    from .sharding.shard import shard_tree

    return params if model.mesh is None else shard_tree(params, model.layout, model.mesh)


def train_state_from_jax(state: Any, pod: Optional[int] = None) -> Dict[str, Any]:
    """A JAX train state ``{"params", "opt": {"step", "mu", "nu"}}`` (and
    ``"ef"``) as the port's: the same keys, each tree flattened as
    :func:`params_from_jax` does (load it with
    ``launch.steps.restore_train_state``).  A multi-pod state, whose leaves
    carry a leading pod dim as ``train_state_specs(model, run, npods)`` lays
    them out (every leaf in ``local`` mode, ``ef`` under int8 ``sync``),
    gives pod ``pod``'s slice."""
    opt = state["opt"]
    local = np.ndim(opt["step"]) == 1
    if (local or "ef" in state) and pod is None:
        raise ValueError("a multi-pod train state: name the pod whose slice to take")

    def tree(t, has_pod: bool) -> Dict[str, torch.Tensor]:
        flat = params_from_jax(t)
        return {k: v[pod] for k, v in flat.items()} if has_pod else flat

    step = _to_tensor(opt["step"])
    out = {"params": tree(state["params"], local),
           "opt": {"step": step[pod] if local else step,
                   "mu": tree(opt["mu"], local), "nu": tree(opt["nu"], local)}}
    if "ef" in state:
        out["ef"] = tree(state["ef"], True)
    return out
