"""Model inputs: synthetic batches from a ``torch.Generator``.

Port of ``repro/models/io.py``'s concrete half.  The ``[audio]`` and
``[vlm]`` frontends are stubs, as in the reference: the batch carries
precomputed frame or patch embeddings at ``d_model``, ``0.02`` times a
standard normal draw.  On a mesh a rank takes its rows of each input as
``sharding.rules.batch_pspec`` lays them on ``(pod, data)``, pod-major
(:func:`rank_inputs`), the frontends' ``embeds`` with the tokens.
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
    """This rank's rows of a global batch, the reference's ``batch_pspec``
    with ``batch_axes=("pod", "data")``: every input that it puts on those
    axes in ``P·D`` equal row blocks, rank ``(p, d)`` the ``(p·D + d)``-th
    (a rank of one pod and one data rank: ``batch`` itself), for every arch:
    a MoE model's groups span the row ranks (``models/moe.py``)."""
    from ..sharding.rules import batch_pspec  # the rules import this package
    from ..sharding.shard import ROWS, row_rank

    i, n_rows = row_rank(mesh, ROWS)
    if n_rows == 1:
        return batch
    specs = batch_pspec(cfg, shape, batch_axes=ROWS)
    out = {}
    for k, v in batch.items():
        if specs.get(k, (None,))[0] == ROWS:
            if v.shape[0] % n_rows:
                raise ValueError(f"{k}: {v.shape[0]} rows do not split over {n_rows} "
                                 f"{ROWS} ranks")
            n = v.shape[0] // n_rows
            v = v[i * n:(i + 1) * n]
        out[k] = v
    return out
