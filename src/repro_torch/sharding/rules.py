"""Sharding rules for the production meshes.

Port of ``repro/sharding/rules.py``, rule for rule, over the port's
``ParamSpec``.  Parameters are 2-D sharded: every weight matrix puts its
"wide" structured dim (vocab / heads / mlp / expert) on the ``model`` axis
(TP/EP) and its d_model dim on the ``data`` axis (FSDP).  Activations shard
batch on ``data`` and the head/mlp/vocab dim on ``model``.  The ``pod`` axis
never appears in parameter specs: parameters are replicated across pods and
reconciled by the cohort schedule (``repro_torch.core.cohort``), which is
the paper's asymmetric design — the slow fabric only ever carries gradient
fragments.

KV caches shard batch on ``data`` and heads on ``model`` (MLA latent caches
have no head dim — batch on ``data`` only).

A partition spec is a tuple with one entry per dim: ``None``, a mesh-axis
name, or a tuple of names (``models.specs.pspec``).  Where the reference
takes a JAX ``Mesh``, these functions take anything with a ``shape``
mapping of axis sizes (the port's ``launch.mesh.Mesh``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.specs import pspec, pspec_tree

__all__ = [
    "PARAM_RULES", "ACT_RULES", "fit_pspec", "param_pspecs", "batch_pspec",
    "cache_pspecs",
]

# Logical axis name → mesh axis (parameters).
PARAM_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "mlp": "model",
    "expert": "model",
    "expert2d": ("data", "model"),  # pure EP: one expert per chip at E=256
    "embed": "data",     # FSDP shard of the d_model dim
    "mlp_fsdp": "data",  # FFN dim FSDP (MoE fsdp_f layout)
    "layers": None,      # scanned stack dim stays unsharded
}

# Logical activation axis → mesh axis.
ACT_RULES: Dict[str, Optional[str]] = {
    "batch": "data",
    "heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert2d": ("data", "model"),
    # d_model dim of *weights* gathered for lookup (embed table): FSDP shard.
    "embed_fsdp": "data",
}


def fit_pspec(ps, shape, mesh):
    """Drop mesh axes whose size does not divide the dim (jit in_shardings
    demand exact divisibility; internal constraints pad, input shardings
    don't).  E.g. hubert's vocab=504 on a 16-way model axis → replicated."""
    out = []
    for i, entry in enumerate(ps):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(entry if shape[i] % size == 0 else None)
    return pspec(*out)


def param_pspecs(specs, rules: Optional[Dict] = None):
    return pspec_tree(specs, rules or PARAM_RULES)


def batch_pspec(cfg: ModelConfig, shape: ShapeConfig, batch_axes=("data",)) -> Dict:
    """PartitionSpecs for the input batch dict (batch dim over data axes)."""
    b = pspec(tuple(batch_axes))
    out = {}
    if cfg.frontend == "audio":
        out["embeds"] = b
    elif cfg.frontend == "vision":
        out["embeds"] = b
        out["tokens"] = b
    else:
        out["tokens"] = b
    if shape.kind == "train":
        out["labels"] = b
    if shape.kind == "decode":
        out = {"tokens": b}
    return out


def _cache_leaf_pspec(leaf_shape, batch_axes, model_size: int = 0):
    """Caches: dim0 = batch → data. Head-ful leaves get model on the head dim.

    KVCache k/v [B, S, K, hd]: shard K over `model` when divisible, else the
    head-dim hd — GQA models with K < |model| would otherwise replicate the
    whole cache across the model axis."""
    batch_axes = tuple(batch_axes)
    if len(leaf_shape) == 4:
        if model_size and leaf_shape[2] % model_size != 0 \
                and leaf_shape[3] % model_size == 0:
            return pspec(batch_axes, None, None, "model")
        return pspec(batch_axes, None, "model", None)
    if len(leaf_shape) == 3 and model_size and leaf_shape[1] >= 1024 \
            and leaf_shape[1] % model_size == 0:
        # MLA latent caches [B, S, r] have no head dim: sequence-shard over
        # `model`.
        return pspec(batch_axes, "model", None)
    if len(leaf_shape) == 0:
        return pspec()
    return pspec(batch_axes)


def cache_pspecs(cache_spec, batch_axes=("data",), mesh=None):
    """Specs for the full cache dict {lead, blocks, tail} from
    ``Model.cache`` (or ``models.transformer.cache_tree`` on the ``meta``
    device): each cache's fields in its own type, a tensor field by its
    shape, the ``length`` (a Python int here, a 0-d array in the reference)
    as a 0-d leaf; ``blocks`` leaves carry the stacked dim first."""
    msize = dict(mesh.shape).get("model", 0) if mesh is not None else 0

    def leaf_spec(leaf, stacked: bool):
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else (0,) * stacked
        ps = _cache_leaf_pspec(shape[1:] if stacked else shape, batch_axes, msize)
        return pspec(None, *ps) if stacked else ps

    def one(cache, stacked: bool):
        return type(cache)(*(leaf_spec(f, stacked) for f in cache))

    return {"lead": [one(c, False) for c in cache_spec["lead"]],
            "tail": [one(c, False) for c in cache_spec["tail"]],
            "blocks": ({k: one(c, True) for k, c in cache_spec["blocks"].items()}
                       if cache_spec["blocks"] else None)}
