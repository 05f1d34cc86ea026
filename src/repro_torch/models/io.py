"""Model inputs: synthetic batches from a ``torch.Generator``.

Port of ``repro/models/io.py``'s concrete half.  The ``[audio]`` and
``[vlm]`` frontends are stubs, as in the reference: the batch carries
precomputed frame or patch embeddings at ``d_model``, ``0.02`` times a
standard normal draw.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, generator: torch.Generator,
                device: torch.device, dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Inputs for one cell, drawn on ``device`` from ``generator``.

    train: ``tokens`` ``[B, T]`` (audio: ``embeds`` ``[B, T, D]``; vision:
    ``embeds`` ``[B, frontend_tokens, D]`` and ``tokens`` ``[B, T -
    frontend_tokens]``) and ``labels`` over the text positions (audio: every
    frame).  prefill: the same without labels.  decode: ``tokens`` ``[B,
    1]``; the cache comes from ``Model.cache``.  Embeddings are in ``dtype``,
    tokens and labels ``int64``.
    """
    B, T = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (B, n), generator=generator, device=device,
                             dtype=torch.int64)

    def embeds(n):
        return (0.02 * torch.randn((B, n, cfg.d_model), generator=generator,
                                   device=device)).to(dtype)

    if shape.kind == "decode":
        return {"tokens": tokens(1)}
    if cfg.frontend == "audio":
        batch = {"embeds": embeds(T)}
    elif cfg.frontend == "vision":
        batch = {"embeds": embeds(cfg.frontend_tokens), "tokens": tokens(T - cfg.frontend_tokens)}
    else:
        batch = {"tokens": tokens(T)}
    if shape.kind == "train":
        batch["labels"] = tokens(T - cfg.frontend_tokens if cfg.frontend == "vision" else T)
    return batch
