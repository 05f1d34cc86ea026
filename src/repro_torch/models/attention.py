"""GQA attention: train and prefill (flash kernel), decode against a KV cache.

Port of the GQA half of ``repro/models/attention.py``.  Train mode
(:func:`gqa_attention`) and prefill call ``kernels.ops.flash_attention``
where the JAX package calls ``online_attention`` on the CPU (and its Pallas
kernel with ``use_pallas``): the two implement one contract
(``tests/test_kernels.py::test_online_attention_equals_kernel_contract``),
and on a CPU tensor ``ops`` runs its plain quadratic version, so
``online_attention`` has no separate port.  Decode attention stays plain
tensor ops, as it is in the JAX package.

Unlike JAX's immutable arrays, the cache here is written in place: prefill
copies into the buffers ``Model.cache`` allocated, and each decode step
writes one slot.  ``KVCache.length`` is a Python int, the same for every
layer, so the slot arithmetic never waits on the device.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import rope
from .specs import ParamSpec

_NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """[B, T, K, d] → [B, T, H, d] by repeating each KV head H//K times."""
    K = k.shape[2]
    return k if K == H else torch.repeat_interleave(k, H // K, dim=2)


def decode_attention(
    q: torch.Tensor,         # [B, 1, H, dk]
    k_cache: torch.Tensor,   # [B, S, K, dk]
    v_cache: torch.Tensor,   # [B, S, K, dv]
    length: Union[int, torch.Tensor],  # [B] or scalar — #valid cache entries
    *,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, S, K, dk = k_cache.shape
    H = q.shape[2]
    kc = _expand_kv(k_cache, H)
    vc = _expand_kv(v_cache, H)
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kc.float()) * scale
    pos = torch.arange(S, device=q.device)[None, :]
    # An int length stays a Python scalar: no host-to-device copy per step.
    lb = length if isinstance(length, int) else length.reshape(-1, 1)
    valid = (pos < lb).expand(B, S)
    if window > 0:
        valid = valid & (pos >= lb - window)
    s = s.masked_fill(~valid[:, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p.to(vc.dtype), vc)
    return out[:, None]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------
def gqa_spec(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamSpec((D, H * hd), ("embed", "heads"), dtype=dtype),
        "wk": ParamSpec((D, K * hd), ("embed", "heads"), dtype=dtype),
        "wv": ParamSpec((D, K * hd), ("embed", "heads"), dtype=dtype),
        "wo": ParamSpec((H * hd, D), ("heads", "embed"), dtype=dtype),
    }


class KVCache(NamedTuple):
    k: torch.Tensor      # [B, S, K, hd] (stacked: [L, B, S, K, hd])
    v: torch.Tensor
    length: int          # tokens currently cached


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device: torch.device) -> KVCache:
    """A zeroed cache; ``S = min(max_len, window)`` when windowed."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    S = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, S, K, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def _project_qkv(p, x, cfg: ModelConfig, positions):
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, K, hd)
    v = (x @ p["wv"]).reshape(B, T, K, hd)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def gqa_attention(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Training self-attention. x: [B, T, D] → [B, T, D]."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.flash_attention(q, k, v, cfg.causal, cfg.window, cfg.q_block,
                              cfg.k_block)
    return out.reshape(B, T, -1) @ p["wo"]


def gqa_prefill(p, x, cfg: ModelConfig, cache: KVCache):
    """Prefill: run attention AND fill ``cache`` in place (ring-buffered if
    windowed).  x: [B, T, D] → ([B, T, D], cache with length T)."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.flash_attention(q, k, v, cfg.causal, cfg.window, cfg.q_block,
                              cfg.k_block)
    S = cache.k.shape[1]
    if T >= S:
        ck, cv = k[:, T - S:], v[:, T - S:]
        if cfg.window > 0:
            # Ring-buffer layout: token t lives at slot t % S so decode's
            # ``pos % S`` overwrite hits the oldest entry.
            ck = torch.roll(ck, shifts=T % S, dims=1)
            cv = torch.roll(cv, shifts=T % S, dims=1)
        cache.k.copy_(ck)
        cache.v.copy_(cv)
    else:
        cache.k[:, :T].copy_(k)
        cache.v[:, :T].copy_(v)
        cache.k[:, T:].zero_()
        cache.v[:, T:].zero_()
    y = out.reshape(B, T, -1) @ p["wo"]
    return y, cache._replace(length=T)


def gqa_decode(p, x, cfg: ModelConfig, cache: KVCache):
    """One decode step. x: [B, 1, D]; writes the new token's K/V into
    ``cache`` in place and returns ([B, 1, D], cache with length + 1)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pos = cache.length  # absolute position of the new token
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, K, hd)
    v = (x @ p["wv"]).reshape(B, 1, K, hd)
    ppos = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, ppos, cfg.rope_theta)
    k = rope(k, ppos, cfg.rope_theta)
    S = cache.k.shape[1]
    slot = pos % S if cfg.window > 0 else min(pos, S - 1)
    cache.k[:, slot].copy_(k[:, 0])
    cache.v[:, slot].copy_(v[:, 0])
    n_valid = min(pos + 1, S) if cfg.window > 0 else pos + 1
    out = decode_attention(q, cache.k, cache.v, n_valid)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, cache._replace(length=pos + 1)
