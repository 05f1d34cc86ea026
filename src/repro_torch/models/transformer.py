"""Model assembly for the dense GQA decoder: embed → layer stack → tied logits.

Port of ``repro/models/transformer.py`` for ``block_pattern == ("attn",)``.
The parameters mirror the JAX tree (``embed.table``,
``blocks.b0.{ln1,attn,ln2,ffn}.*`` stacked on a leading layer dim,
``final_norm.scale``), so ``convert.params_from_jax`` loads a JAX
``Model.init`` tree one-to-one.  A Python loop over the stacked leading dim
replaces ``lax.scan``.

Entry points: ``prefill(batch, max_len)`` and ``decode_step(caches, tokens)``.
Training (``loss``/``forward``) is later work.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn
from .layers import embed, embed_spec, mlp, mlp_spec, rmsnorm, rmsnorm_spec, unembed, unembed_spec
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
    if tuple(cfg.block_pattern) != ("attn",):
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
            f"{cfg.name}: the port runs dense GQA decoders only; not yet: "
            + ", ".join(unsupported))


def _block_spec(cfg: ModelConfig, dtype) -> Dict:
    return {
        "ln1": rmsnorm_spec(cfg.d_model, dtype),
        "attn": attn.gqa_spec(cfg, dtype),
        "ln2": rmsnorm_spec(cfg.d_model, dtype),
        "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def _block_apply(cfg: ModelConfig, p, x, mode: str, cache: attn.KVCache):
    """One pre-norm block. mode: prefill | decode. Returns (x, cache)."""
    h = rmsnorm(p["ln1"], x)
    if mode == "prefill":
        y, cache = attn.gqa_prefill(p["attn"], h, cfg, cache)
    else:
        y, cache = attn.gqa_decode(p["attn"], h, cfg, cache)
    x = x + y
    return x + mlp(p["ffn"], rmsnorm(p["ln2"], x), cfg.act), cache


def model_specs(cfg: ModelConfig) -> Dict:
    """The parameter spec tree, without allocating anything."""
    _check_supported(cfg)
    dt = _DTYPES[cfg.dtype]
    out: Dict[str, Any] = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model, dt),
        "blocks": stack_layer_specs({"b0": _block_spec(cfg, dt)}, layer_plan(cfg).n_scan),
        "final_norm": rmsnorm_spec(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = unembed_spec(cfg.vocab_size, cfg.d_model, dt)
    return out


class ParamTree(nn.Module):
    """Nested parameters under the JAX tree's keys; ``tree["key"]`` reads one."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def layer(self, i: int) -> Dict[str, Any]:
        """The tree of every parameter's slice ``[i]`` along the stacked dim."""
        out = {name: mod.layer(i) for name, mod in self.named_children()}
        out.update((name, t[i]) for name, t in self.named_parameters(recurse=False))
        return out


class Model(nn.Module):
    """llama-style decoder: ``prefill`` then ``decode_step``, on one device.

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
        self.final_norm = ParamTree(params["final_norm"])
        if "unembed" in params:
            self.unembed = ParamTree(params["unembed"])

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ self.embed["table"].T
        return unembed(self.unembed, h)

    def cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Zeroed KV caches, stacked like the JAX tree: ``blocks.b0`` holds
        ``[L, B, S, K, hd]`` buffers."""
        c = attn.gqa_cache_spec(self.cfg, batch, max_len, self.dtype, self.device)
        n = self.plan.n_scan
        stacked = attn.KVCache(k=c.k.expand(n, *c.k.shape).clone(),
                               v=c.v.expand(n, *c.v.shape).clone(), length=0)
        return {"lead": [], "blocks": {"b0": stacked}, "tail": []}

    def _stack(self, x: torch.Tensor, mode: str, caches: Dict[str, Any]):
        c = caches["blocks"]["b0"]
        length = c.length
        for i in range(self.plan.n_scan):
            p = self.blocks.layer(i)["b0"]
            x, layer_cache = _block_apply(
                self.cfg, p, x, mode, attn.KVCache(c.k[i], c.v[i], c.length))
            length = layer_cache.length
        new = c._replace(length=length)
        return x, {"lead": [], "blocks": {"b0": new}, "tail": []}

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
