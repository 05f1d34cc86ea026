"""Model inputs: synthetic batches from a ``torch.Generator``.

Port of ``repro/models/io.py``'s concrete half.  The ``[audio]`` and
``[vlm]`` frontends are stubs, as in the reference: the batch carries
precomputed frame or patch embeddings at ``d_model``, ``0.02`` times a
standard normal draw.  On a mesh a rank takes its rows of each input as
``sharding.rules.batch_pspec`` lays them on ``data`` (:func:`rank_inputs`),
the frontends' ``embeds`` with the tokens.
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


def rank_inputs(batch: Dict[str, torch.Tensor], cfg: ModelConfig, shape: ShapeConfig,
                mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: every input that ``batch_pspec``
    puts on ``data`` in ``D`` equal row blocks, data rank ``d`` the
    ``d``-th (a rank of no data axis: ``batch`` itself)."""
    from ..sharding.rules import batch_pspec  # the rules import this package

    D = mesh.size("data") if mesh is not None else 1
    if D == 1:
        return batch
    d, specs = mesh.coords["data"], batch_pspec(cfg, shape)
    out = {}
    for k, v in batch.items():
        if specs.get(k, (None,))[0] == "data":
            if v.shape[0] % D:
                raise ValueError(f"{k}: {v.shape[0]} rows do not split over {D} data ranks")
            n = v.shape[0] // D
            v = v[d * n:(d + 1) * n]
        out[k] = v
    return out
