"""Model assembly: embed → layer stack → tied logits, for GQA decoders built
from ``"attn"`` and ``"rec"`` (RG-LRU) blocks.

Port of ``repro/models/transformer.py`` for the dense (``("attn",)``) and
hybrid (``("rec", "rec", "attn")``) patterns.  The parameters mirror the JAX
tree (``embed.table``; ``blocks.b{i}.*`` for the super-block pattern, stacked
on a leading dim of ``n_scan``; ``tail.{j}.*`` for the unrolled trailing
layers; ``final_norm.scale``), so ``convert.params_from_jax`` loads a JAX
``Model.init`` tree one-to-one.  A Python loop over the stacked leading dim
replaces ``lax.scan``.  Caches are stacked the same way and written in place.

Entry points: ``loss(batch)`` and ``forward(batch)`` (training: gradients
reach every parameter, each stacked super-block under
``torch.utils.checkpoint`` unless ``cfg.remat == "none"``), and
``prefill(batch, max_len)`` and ``decode_step(caches, tokens)`` (serving,
under ``torch.inference_mode``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn
from . import recurrent as rec
from .layers import (chunked_xent, embed, embed_spec, mlp, mlp_spec, rmsnorm, rmsnorm_spec,
                     softmax_xent, unembed, unembed_spec)
from .specs import init_params, stack_layer_specs

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LayerPlan(NamedTuple):
    lead: Tuple[str, ...]       # unrolled leading layers (kinds)
    pattern: Tuple[str, ...]    # stacked super-block pattern
    n_scan: int                 # number of stacked super-blocks
    tail: Tuple[str, ...]       # unrolled trailing layers


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    kinds: List[str] = [
        cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.num_layers)
    ]
    n_lead = cfg.moe.num_dense_layers if cfg.moe is not None else 0
    lead = tuple("attn_dense" for _ in range(n_lead))
    rest = kinds[n_lead:]
    p = len(cfg.block_pattern)
    n_scan = len(rest) // p
    tail = tuple(rest[n_scan * p:])
    return LayerPlan(lead=lead, pattern=tuple(cfg.block_pattern), n_scan=n_scan,
                     tail=tail)


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    if not set(cfg.block_pattern) <= {"attn", "rec"}:
        unsupported.append(f"block_pattern={cfg.block_pattern}")
    if cfg.attention != "gqa":
        unsupported.append(f"attention={cfg.attention!r}")
    if cfg.moe is not None:
        unsupported.append("moe")
    if cfg.frontend != "none":
        unsupported.append(f"frontend={cfg.frontend!r}")
    if cfg.mtp_depth:
        unsupported.append("mtp")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the port runs GQA decoders of attention and RG-LRU "
            "blocks only; not yet: "
            + ", ".join(unsupported))


def _block_spec(cfg: ModelConfig, kind: str, dtype) -> Dict:
    mixer = attn.gqa_spec(cfg, dtype) if kind == "attn" else rec.rglru_block_spec(cfg, dtype)
    return {
        "ln1": rmsnorm_spec(cfg.d_model, dtype),
        kind: mixer,
        "ln2": rmsnorm_spec(cfg.d_model, dtype),
        "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def _block_apply(cfg: ModelConfig, kind: str, p, x, mode: str, cache):
    """One pre-norm block. mode: train | prefill | decode.  ``cache`` (a
    ``KVCache`` or an ``RGLRUState`` of buffers; ``None`` in train mode) is
    written in place.  Returns (x, cache)."""
    h = rmsnorm(p["ln1"], x)
    if mode == "train":
        if kind == "attn":
            y = attn.gqa_attention(p["attn"], h, cfg)
        else:
            y = rec.rglru_block(p["rec"], h, cfg)
    elif kind == "attn":
        step = attn.gqa_prefill if mode == "prefill" else attn.gqa_decode
        y, cache = step(p["attn"], h, cfg, cache)
    else:
        if mode == "prefill":
            y, new = rec.rglru_block_with_state(p["rec"], h, cfg, None)
        else:
            y, new = rec.rglru_decode(p["rec"], h, cfg, cache)
        cache.h.copy_(new.h)
        cache.conv.copy_(new.conv)
    x = x + y
    return x + mlp(p["ffn"], rmsnorm(p["ln2"], x), cfg.act), cache


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                 device: torch.device):
    if kind == "attn":
        return attn.gqa_cache_spec(cfg, batch, max_len, dtype, device)
    return rec.rglru_state_spec(cfg, batch, device)


def _stacked(cache, n: int):
    """``n`` copies of a zeroed cache, stacked on a new leading dim."""
    return cache._replace(**{f: t.expand(n, *t.shape).clone()
                             for f, t in cache._asdict().items()
                             if isinstance(t, torch.Tensor)})


def _layer(cache, i: int):
    """Views of layer ``i`` of a stacked cache."""
    return cache._replace(**{f: t[i] for f, t in cache._asdict().items()
                             if isinstance(t, torch.Tensor)})


def model_specs(cfg: ModelConfig) -> Dict:
    """The parameter spec tree, without allocating anything."""
    _check_supported(cfg)
    dt = _DTYPES[cfg.dtype]
    plan = layer_plan(cfg)
    sb = {f"b{i}": _block_spec(cfg, k, dt) for i, k in enumerate(plan.pattern)}
    out: Dict[str, Any] = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model, dt),
        "blocks": stack_layer_specs(sb, plan.n_scan),
        "tail": [_block_spec(cfg, k, dt) for k in plan.tail],
        "final_norm": rmsnorm_spec(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = unembed_spec(cfg.vocab_size, cfg.d_model, dt)
    return out


class ParamTree(nn.Module):
    """Nested parameters under the JAX tree's keys; ``tree["key"]`` reads one.
    A list becomes a tree keyed ``"0"``, ``"1"``, ... as ``params_from_jax``
    flattens it."""

    def __init__(self, tree):
        super().__init__()
        if isinstance(tree, list):
            tree = {str(i): v for i, v in enumerate(tree)}
        for key, val in tree.items():
            if isinstance(val, (dict, list)):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def layer(self, i: int) -> Dict[str, Any]:
        """The tree of every parameter's slice ``[i]`` along the stacked dim."""
        out = {name: mod.layer(i) for name, mod in self.named_children()}
        out.update((name, t[i]) for name, t in self.named_parameters(recurse=False))
        return out


class Model(nn.Module):
    """Decoder (dense or hybrid) on one device: ``loss`` for training,
    ``prefill`` then ``decode_step`` for serving.

    Parameters are drawn on ``device`` from ``generator`` (a ``torch.Generator``
    on that device; seed 0 when omitted), with the JAX package's initializers.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.dtype = _DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        params = init_params(model_specs(cfg), generator, self.device)
        self.embed = ParamTree(params["embed"])
        self.blocks = ParamTree(params["blocks"])
        self.tail = ParamTree(params["tail"])
        self.final_norm = ParamTree(params["final_norm"])
        if "unembed" in params:
            self.unembed = ParamTree(params["unembed"])

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ self.embed["table"].T
        return unembed(self.unembed, h)

    def cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Zeroed caches shaped like the JAX tree: ``blocks.b{i}`` stacks
        ``n_scan`` layers (``KVCache`` k/v ``[n, B, S, K, hd]``, ``RGLRUState``
        h ``[n, B, W]`` and conv ``[n, B, 3, W]``), ``tail`` holds one per layer."""
        mk = lambda kind: _block_cache(self.cfg, kind, batch, max_len, self.dtype,
                                       self.device)
        plan = self.plan
        blocks = {f"b{i}": _stacked(mk(k), plan.n_scan) for i, k in enumerate(plan.pattern)}
        return {"lead": [], "blocks": blocks, "tail": [mk(k) for k in plan.tail]}

    def _stack(self, x: torch.Tensor, mode: str, caches: Dict[str, Any]):
        """Stacked super-blocks, then the tail.  Caches are written in place;
        the returned tree carries the new KV lengths."""
        plan = self.plan
        blocks = caches["blocks"]
        lengths = {}  # every layer of one stack starts from the same length
        for i in range(plan.n_scan):
            p_sb = self.blocks.layer(i)
            for j, kind in enumerate(plan.pattern):
                key = f"b{j}"
                x, c = _block_apply(self.cfg, kind, p_sb[key], x, mode,
                                    _layer(blocks[key], i))
                if kind == "attn":
                    lengths[key] = c.length
        blocks = {k: c._replace(length=lengths[k]) if k in lengths else c
                  for k, c in blocks.items()}
        tail = []
        for j, kind in enumerate(plan.tail):
            x, c = _block_apply(self.cfg, kind, self.tail[str(j)], x, mode,
                                caches["tail"][j])
            tail.append(c)
        return x, {"lead": [], "blocks": blocks, "tail": tail}

    def _train_stack(self, x: torch.Tensor) -> torch.Tensor:
        """Stacked super-blocks, each under remat unless ``cfg.remat`` is
        ``"none"`` (the reference's per-super-block ``jax.checkpoint``), then
        the unrolled tail."""
        plan = self.plan

        def superblock(i: int, x: torch.Tensor) -> torch.Tensor:
            p_sb = self.blocks.layer(i)
            for j, kind in enumerate(plan.pattern):
                x, _ = _block_apply(self.cfg, kind, p_sb[f"b{j}"], x, "train", None)
            return x

        for i in range(plan.n_scan):
            if self.cfg.remat != "none":
                x = checkpoint(superblock, i, x, use_reentrant=False)
            else:
                x = superblock(i, x)
        for j, kind in enumerate(plan.tail):
            x, _ = _block_apply(self.cfg, kind, self.tail[str(j)], x, "train", None)
        return x

    def forward(self, batch: Dict[str, torch.Tensor]):
        """Training-mode forward to final hidden states [B, T, D], and the
        auxiliary loss (0: no MoE)."""
        x = self._train_stack(embed(self.embed, batch["tokens"]))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return rmsnorm(self.final_norm, x), aux

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Mean next-token cross-entropy over ``labels`` (and ``mask``);
        returns (total, metrics with ``ce`` and ``loss``).  From T 2048 the
        logits are taken in chunks (:func:`chunked_xent`)."""
        h, _ = self.forward(batch)
        labels, mask = batch["labels"], batch.get("mask")
        if labels.shape[1] >= 2048:
            ce = chunked_xent(h, self._logits, labels, mask)
        else:
            ce = softmax_xent(self._logits(h), labels, mask)
        return ce, {"ce": ce, "loss": ce}

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        """Process the prompt; returns (last-token logits [B, 1, V], caches)."""
        tokens = batch["tokens"]
        x = embed(self.embed, tokens)
        caches = self.cache(tokens.shape[0], max_len)
        x, caches = self._stack(x, "prefill", caches)
        h = rmsnorm(self.final_norm, x[:, -1:])
        return self._logits(h), caches

    @torch.inference_mode()
    def decode_step(self, caches: Dict[str, Any], tokens: torch.Tensor):
        """One token for every sequence. tokens: [B, 1] → logits [B, 1, V]."""
        x = embed(self.embed, tokens)
        x, caches = self._stack(x, "decode", caches)
        return self._logits(rmsnorm(self.final_norm, x)), caches
