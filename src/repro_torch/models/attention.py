"""Attention: GQA and MLA, train and prefill (flash kernel), decode against
a cache.

Port of ``repro/models/attention.py``.  Train mode (:func:`gqa_attention`,
:func:`mla_attention`) and prefill call ``kernels.ops.flash_attention``
where the JAX package calls ``online_attention`` on the CPU (and its Pallas
kernel with ``use_pallas``): the two implement one contract
(``tests/test_kernels.py::test_online_attention_equals_kernel_contract``),
and on a CPU tensor ``ops`` runs its plain quadratic version, so
``online_attention`` has no separate port.  Decode attention stays plain
tensor ops, as it is in the JAX package: GQA against its KV cache, MLA
(DeepSeek's multi-head latent attention) by the absorbed-weight product in
the latent space of its compressed cache.

Under tensor parallelism a rank holds a contiguous block of the query heads
and of the KV heads (``wq``/``wk``/``wv`` split on their output dim, ``wo``
on its input dim), so the head counts come from the weights' shapes: with
``K % M == 0`` local query head ``i`` reads local KV head ``i // (H/K)``,
the reference's map.  Where the KV heads do not split (``K % M``) but
their ``K·hd`` columns do, ``wk`` and ``wv`` split those columns
contiguously, so a rank holds a slice of a KV head's head dim
(recurrentgemma-9b on model 2: 128 of its one head's 256).  RoPE pairs
``x[:d/2]`` with ``x[d/2:]``, so such a slice cannot be rotated alone: prefill
and training gather k and v whole over ``model`` first
(``sharding.shard.all_gather_model``, whose backward sums dk and dv over
the ranks whose query heads read them), rotate, and run flash with the
rank's ``H/M`` query heads against the KV heads they read.  The cache then
holds, as the reference's ``_cache_leaf_pspec`` puts ``hd`` on ``model``,
the rank's ``hd/M`` slice of every KV head of the rotated k and of v
``[B, S, K, hd/M]``.  Decode gathers the new token's k and v whole (to
rotate k), writes its slice, and gathers the cache whole over ``model``
for its query heads: per layer and step an all-gather of ``2·B·K·hd``
elements and one of ``2·B·S·K·hd`` (:func:`gqa_decode`).  Splitting the
scores over ``hd`` instead would move ``B·H·S`` fp32 partial scores, but
also every query head's q and output slices: four exchanges a layer where
this takes two, and on a card whose ranks talk through host memory a call
costs more than these bytes.  MLA's up-projections (``w_uq``, ``w_uk``, ``w_uv``)
and ``wo`` hold the rank's heads; its down-projections, their norms and
``w_kr`` are whole on every model rank, so Megatron's *f* sits on the
latents where they meet the rank's heads (``tp``), and the latent cache
stays whole on every model rank.

Unlike JAX's immutable arrays, the caches here are written in place: prefill
copies into the buffers ``Model.cache`` allocated, and each decode step
writes one slot.  ``KVCache.length`` and ``MLACache.length`` are Python
ints, the same for every layer, so the slot arithmetic never waits on the
device.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..sharding.shard import all_gather_model, copy_to_model, gather_model
from .layers import rmsnorm, rmsnorm_spec, rope
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


def head_dim_split(cfg: ModelConfig, model_size: int) -> bool:
    """Whether a rank of ``model_size`` holds a slice of the KV heads' head
    dim: the KV heads do not split over ``model``."""
    return model_size > 1 and cfg.num_kv_heads % model_size != 0


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device: torch.device, model_size: int = 1) -> KVCache:
    """A zeroed cache; ``S = min(max_len, window)`` when windowed; a rank's
    ``K / model_size`` KV heads, or where they do not split its
    ``hd / model_size`` slice of every head."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if head_dim_split(cfg, model_size):
        hd //= model_size
    else:
        K //= model_size
    S = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, S, K, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def _heads_of(p, cfg: ModelConfig):
    """(query heads, KV heads, head dim) that ``p``'s weights hold (the KV
    heads only where they split over ``model``)."""
    hd = cfg.resolved_head_dim
    return p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd, hd


def _split(tp, cfg: ModelConfig):
    """``tp`` where its ranks hold slices of the KV heads' head dim, else None."""
    return tp if tp is not None and head_dim_split(cfg, tp.size("model")) else None


def _kv_whole(p, x, cfg: ModelConfig, positions, tp):
    """k (rotated) and v ``[B, T, K, hd]`` whole from the rank's contiguous
    ``K·hd/M`` columns of ``wk`` and ``wv``: one all-gather over ``model``
    of both, then RoPE over whole heads."""
    kv = all_gather_model(torch.stack([x @ p["wk"], x @ p["wv"]]), tp)
    k, v = kv.unflatten(-1, (cfg.num_kv_heads, cfg.resolved_head_dim)).unbind(0)
    return rope(k, positions, cfg.rope_theta), v


def _read_heads(k: torch.Tensor, H: int, cfg: ModelConfig, tp) -> torch.Tensor:
    """The KV heads of whole ``k`` ``[B, T, K, d]`` that the rank's ``H``
    query heads read, in the grouping flash takes: the one head where the
    rank's queries lie in one head's group, else one a query head."""
    K = cfg.num_kv_heads
    per = cfg.num_heads // K
    first = tp.coords["model"] * H
    if per % H == 0:
        return k.narrow(2, first // per, 1)
    return k.index_select(2, torch.arange(first, first + H, device=k.device) // per)


def _cache_slice(t: torch.Tensor, tp) -> torch.Tensor:
    """The rank's ``hd/M`` slice of every head of ``t`` ``[..., K, hd]``."""
    n = t.shape[-1] // tp.size("model")
    return t.narrow(-1, tp.coords["model"] * n, n)


def _project_qkv(p, x, cfg: ModelConfig, positions, tp=None):
    """q, k, v of the rank's heads; under the head-dim split (``tp``) k and v
    whole (:func:`_kv_whole`)."""
    B, T, _ = x.shape
    H, K, hd = _heads_of(p, cfg)
    q = rope((x @ p["wq"]).reshape(B, T, H, hd), positions, cfg.rope_theta)
    if tp is not None:
        return (q, *_kv_whole(p, x, cfg, positions, tp))
    k = (x @ p["wk"]).reshape(B, T, K, hd)
    v = (x @ p["wv"]).reshape(B, T, K, hd)
    return q, rope(k, positions, cfg.rope_theta), v


def _flash(q, k, v, cfg: ModelConfig, tp):
    if tp is not None:
        k, v = (_read_heads(t, q.shape[2], cfg, tp).contiguous() for t in (k, v))
    return ops.flash_attention(q, k, v, cfg.causal, cfg.window, cfg.q_block, cfg.k_block)


def gqa_attention(p, x, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Training self-attention. x: [B, T, D] → [B, T, D].  ``tp``: the
    model axis (x after *f*, the output the rank's partial sum)."""
    B, T, _ = x.shape
    tp = _split(tp, cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    return _flash(q, k, v, cfg, tp).reshape(B, T, -1) @ p["wo"]


def gqa_prefill(p, x, cfg: ModelConfig, cache: KVCache, tp=None):
    """Prefill: run attention AND fill ``cache`` in place (ring-buffered if
    windowed).  x: [B, T, D] → ([B, T, D], cache with length T)."""
    B, T, _ = x.shape
    tp = _split(tp, cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    out = _flash(q, k, v, cfg, tp)
    if tp is not None:
        k, v = _cache_slice(k, tp), _cache_slice(v, tp)
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


def gqa_decode(p, x, cfg: ModelConfig, cache: KVCache, tp=None):
    """One decode step. x: [B, 1, D]; writes the new token's K/V into
    ``cache`` in place and returns ([B, 1, D], cache with length + 1).
    Under the head-dim split the cache is gathered whole over ``model`` for
    the rank's query heads (the module's docstring counts its bytes)."""
    B = x.shape[0]
    tp = _split(tp, cfg)
    pos = cache.length  # absolute position of the new token
    ppos = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, ppos, tp)
    if tp is not None:
        k, v = _cache_slice(k, tp), _cache_slice(v, tp)
    S = cache.k.shape[1]
    slot = pos % S if cfg.window > 0 else min(pos, S - 1)
    cache.k[:, slot].copy_(k[:, 0])
    cache.v[:, slot].copy_(v[:, 0])
    n_valid = min(pos + 1, S) if cfg.window > 0 else pos + 1
    kc, vc = cache.k, cache.v
    if tp is not None:
        kc, vc = (_read_heads(t, q.shape[2], cfg, tp)
                  for t in gather_model(torch.stack([kc, vc]), tp).unbind(0))
    out = decode_attention(q, kc, vc, n_valid)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, cache._replace(length=pos + 1)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------
def mla_spec(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    spec: Dict = {
        "w_dkv": ParamSpec((D, m.kv_lora_rank), ("embed", None), dtype=dtype),
        "kv_norm": rmsnorm_spec(m.kv_lora_rank, dtype),
        "w_uk": ParamSpec((m.kv_lora_rank, H, dn), (None, "heads", None), dtype=dtype),
        "w_uv": ParamSpec((m.kv_lora_rank, H, dv), (None, "heads", None), dtype=dtype),
        "w_kr": ParamSpec((D, dr), ("embed", None), dtype=dtype),
        "wo": ParamSpec((H * dv, D), ("heads", "embed"), dtype=dtype),
    }
    if m.q_lora_rank:
        spec.update(
            w_dq=ParamSpec((D, m.q_lora_rank), ("embed", None), dtype=dtype),
            q_norm=rmsnorm_spec(m.q_lora_rank, dtype),
            w_uq=ParamSpec((m.q_lora_rank, H, dn + dr), (None, "heads", None), dtype=dtype),
        )
    else:
        spec["wq"] = ParamSpec((D, H, dn + dr), ("embed", "heads", None), dtype=dtype)
    return spec


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # [B, S, kv_lora] (stacked: [L, B, S, kv_lora])
    k_rope: torch.Tensor  # [B, S, dr]
    length: int           # tokens currently cached


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device: torch.device) -> MLACache:
    """A zeroed cache of ``max_len`` positions: no ring buffer, no window."""
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, max_len, m.rope_head_dim), dtype=dtype, device=device),
        length=0)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btr,rhd->bthd", x, w)`` as one matrix product."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _mla_q(p, x, cfg: ModelConfig, positions, tp=None):
    """Queries of the heads that ``p`` holds; *f* on the input of their
    projection (``tp``: the model axis of a sharded mesh)."""
    m = cfg.mla
    if m.q_lora_rank:
        q = _heads(copy_to_model(rmsnorm(p["q_norm"], x @ p["w_dq"]), tp), p["w_uq"])
    else:
        q = _heads(copy_to_model(x, tp), p["wq"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(p, x, cfg: ModelConfig, positions):
    c_kv = rmsnorm(p["kv_norm"], x @ p["w_dkv"])            # [B, T, r]
    k_rope = rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)


def _mla_attend(p, x, cfg: ModelConfig, tp=None):
    """Expand the latents to per-head K/V of the heads that ``p`` holds and
    flash-attend; returns the block's output (the rank's partial sum under
    ``tp``) and the latents (c_kv, k_rope) that prefill caches."""
    B, T, _ = x.shape
    H, dr = p["w_uk"].shape[1], cfg.mla.rope_head_dim
    positions = torch.arange(T, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, positions, tp)
    c_kv, k_rope = _mla_latents(p, x, cfg, positions)
    ck, kr = copy_to_model(c_kv, tp), copy_to_model(k_rope, tp)
    # The kernel takes contiguous q, k, v: each concatenation is a new tensor,
    # with k_rope broadcast over the heads.
    k = torch.cat([_heads(ck, p["w_uk"]), kr[:, :, None, :].expand(B, T, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = _heads(ck, p["w_uv"])
    out = ops.flash_attention(q, k, v, cfg.causal, cfg.window, cfg.q_block, cfg.k_block,
                              _mla_scale(cfg))
    return out.reshape(B, T, -1) @ p["wo"], c_kv, k_rope


def mla_attention(p, x, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Training MLA. x: [B, T, D] (before *f*) → [B, T, D]."""
    return _mla_attend(p, x, cfg, tp)[0]


def mla_prefill(p, x, cfg: ModelConfig, cache: MLACache, tp=None):
    """Prefill: attend and fill ``cache``'s latents in place.
    x: [B, T, D] → ([B, T, D], cache with length T)."""
    T = x.shape[1]
    y, c_kv, k_rope = _mla_attend(p, x, cfg, tp)
    cache.c_kv[:, :T].copy_(c_kv)
    cache.k_rope[:, :T].copy_(k_rope)
    cache.c_kv[:, T:].zero_()
    cache.k_rope[:, T:].zero_()
    return y, cache._replace(length=T)


def mla_decode(p, x, cfg: ModelConfig, cache: MLACache, tp=None):
    """Absorbed-weight decode: score and reduce in the latent space.

    q_lat = q_nope · W_uk  →  scores = q_lat · c_kv + q_rope · k_rope
    out   = (attn · c_kv) · W_uv — the cache stays compressed end-to-end.
    Writes the new token's latents into ``cache`` in place; returns
    ([B, 1, D], cache with length + 1).  The heads are those ``p`` holds;
    the cache is whole.
    """
    B = x.shape[0]
    pos = cache.length
    ppos = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, ppos, tp)
    c_new, kr_new = _mla_latents(p, x, cfg, ppos)
    S = cache.c_kv.shape[1]
    slot = min(pos, S - 1)  # the reference's dynamic_update_slice clamps
    cache.c_kv[:, slot].copy_(c_new[:, 0])
    cache.k_rope[:, slot].copy_(kr_new[:, 0])
    c_kv, k_rope = cache.c_kv, cache.k_rope

    q_lat = torch.einsum("bthd,rhd->bthr", q_nope, p["w_uk"])  # absorb W_uk
    s_lat = torch.einsum("bthr,bsr->bths", q_lat, c_kv)
    s_rope = torch.einsum("bthd,bsd->bths", q_rope, k_rope)
    s = (s_lat + s_rope).float() * _mla_scale(cfg)
    valid = torch.arange(S, device=x.device) < pos + 1
    s = s.masked_fill(~valid, _NEG_INF)
    a = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bths,bsr->bthr", a, c_kv)            # reduce in latent
    out = torch.einsum("bthr,rhd->bthd", o_lat, p["w_uv"])     # absorb W_uv
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, cache._replace(length=pos + 1)
