"""Model inputs: synthetic prompt and decode tokens from a ``torch.Generator``.

Port of the token half of ``repro/models/io.py`` (prefill and decode cells).
The audio and vision stub frontends are later work.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """prefill: ``{"tokens": [B, T]}``; decode: ``{"tokens": [B, 1]}``."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend={cfg.frontend!r} inputs are not ported")
    B = shape.global_batch
    if shape.kind == "prefill":
        T = shape.seq_len
    elif shape.kind == "decode":
        T = 1
    else:
        raise NotImplementedError(f"{shape.kind!r} inputs are not ported")
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=generator,
                           device=device, dtype=torch.int64)
    return {"tokens": tokens}
