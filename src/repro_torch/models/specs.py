"""Declarative parameter specs, materialised with a ``torch.Generator``.

Port of ``repro/models/specs.py``: the same ``ParamSpec`` tree declares every
parameter (shape, logical axes, initializer), and ``init_params`` draws it on
the target device.  The draws differ from ``jax.random``'s; tests that need
equal weights convert the JAX tree with ``repro_torch.convert``.  From the
same declaration :func:`pspec_tree` derives each parameter's partition spec
under logical-to-mesh rules (``repro_torch/sharding/rules.py``): a tuple with
one mesh-axis name, a tuple of names, or ``None`` per dim.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape + logical axes + init recipe."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # one logical name (or None) per dim
    init: str = "fan_in"                # fan_in | normal | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical axes {self.logical}")


def _leaves(specs):
    if isinstance(specs, ParamSpec):
        yield specs
    elif isinstance(specs, dict):
        for v in specs.values():
            yield from _leaves(v)
    elif isinstance(specs, (list, tuple)):
        for v in specs:
            yield from _leaves(v)


def _map(fn, specs):
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map(fn, v) for k, v in specs.items()}
    return [_map(fn, v) for v in specs]


def init_params(specs, generator: torch.Generator, device: torch.device):
    """Materialise a spec tree on ``device``, drawing from ``generator``.

    Initializers follow ``repro/models/specs.py:50-72``: normal draws in
    float32, scaled, then cast to the spec's dtype.  ``generator`` must live
    on ``device`` (a CUDA generator for CUDA weights).
    """

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.init in ("normal", "embed"):
            std = spec.scale
        elif spec.init == "fan_in":
            # Contraction dim is the second-to-last for >=2D (d_in, d_out)
            # weights and stacked (layers, d_in, d_out) weights.
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(f"unknown init {spec.init}")
        x = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=torch.float32)
        # Scaled in place: one fp32 draw at a time is the init's peak (30 GB
        # for deepseek-v2's stacked experts at three layers).
        return x.mul_(std).to(spec.dtype)

    return _map(one, specs)


def pspec(*entries) -> Tuple:
    """A partition spec: one entry per dim, ``None``, a mesh-axis name or a
    tuple of names; a tuple of one name is that name, as ``PartitionSpec``
    normalises it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def logical_to_pspec(logical: Sequence[Optional[str]], rules: Dict) -> Tuple:
    """Map logical axis names to mesh axes via rules; unknown names error."""
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        else:
            if name not in rules:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            out.append(rules[name])
    return pspec(*out)


def pspec_tree(specs, rules: Dict):
    return _map(lambda s: logical_to_pspec(s.logical, rules), specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in _leaves(specs))


def stack_layer_specs(spec_tree, num_layers: int, axis_name: Optional[str] = "layers"):
    """Add a leading stacked-layers dim to every spec."""
    return _map(
        lambda s: ParamSpec(
            shape=(num_layers, *s.shape),
            logical=(axis_name, *s.logical),
            init=s.init,
            scale=s.scale,
            dtype=s.dtype,
        ),
        spec_tree,
    )
