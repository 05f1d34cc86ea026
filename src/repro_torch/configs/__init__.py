"""Architecture registry: ``--arch <id>`` → exact published config.

A copy of the JAX package's registry (plain dataclasses), so the port imports
nothing of it.  Every architecture has a full CONFIG (the published figures)
and a SMOKE config (same family, reduced width/depth) used by CPU tests.  The
port's ``Model`` runs all of them.
"""

from importlib import import_module
from typing import Dict

from .base import (  # noqa: F401
    MeshConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    RunConfig,
    SHAPES,
    ShapeConfig,
    XLSTMConfig,
)

_MODULES: Dict[str, str] = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "glm4-9b": "glm4_9b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "llama3-8b": "llama3_8b",
    "llama3.2-1b": "llama32_1b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-76b": "internvl2_76b",
    "hubert-xlarge": "hubert_xlarge",
    "xlstm-1.3b": "xlstm_13b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def shape_cells(arch: str):
    """The (shape, reason-if-skipped) cells assigned to this arch."""
    cfg = get_config(arch)
    cells = []
    for name, shp in SHAPES.items():
        skip = None
        if shp.kind == "decode" and not cfg.causal:
            skip = "encoder-only architecture has no autoregressive decode"
        elif name == "long_500k" and cfg.family not in ("hybrid", "ssm"):
            skip = "full quadratic attention; 512k dense attention infeasible"
        cells.append((shp, skip))
    return cells
