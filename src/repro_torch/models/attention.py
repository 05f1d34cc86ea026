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
costs more than these bytes.  Where the query heads do not divide over
``model`` but their ``H·hd`` columns do (``gqa_layout`` ``"gathered"``), a
rank's columns of q (and of k and v where theirs split) cut across heads:
they are gathered whole by one ``gather_slices``, the attention runs over
every head on every rank, and its output is cut back to the rank's columns
by ``slice_model`` (whose backward gathers) before ``wo``'s rows and *g*.
Where ``wk`` and ``wv`` are whole, k and v are computed whole from the
block's input before *f*; under split query heads (``"kv_whole"``) they
pass through *f* so that their gradient sums over the ranks whose query
heads read them.  In both the cache holds every KV head whole.  Where no
weight splits (``"whole"``) the block runs whole, with no *f* and no *g*.
MLA's up-projections (``w_uq``, ``w_uk``, ``w_uv``)
and ``wo`` hold the rank's heads; its down-projections, their norms and
``w_kr`` are whole on every model rank, so Megatron's *f* sits on the
latents where they meet the rank's heads (``tp``), and the latent cache
stays whole on every model rank; where the heads do not divide, the
up-projections are whole, the heads run whole with no *f*, and ``wo``'s
rows split as the GQA case above (or stay whole, with no *g*).

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
from ..sharding.shard import (all_gather_model, copy_to_model, gather_model, gather_slices,
                              reduce_from_model, slice_model)
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


def gqa_layout(cfg: ModelConfig, model_size: int) -> str:
    """How ``sharding.shard.param_layout`` lays GQA's weights over
    ``model_size`` model ranks (``fit_pspec``: a dim splits where it divides),
    and so what a rank computes: ``"heads"`` (its query and KV heads),
    ``"head_dim"`` (its query heads; ``wk``/``wv`` split their ``K·hd``
    columns though the KV heads do not split), ``"kv_whole"`` (its query
    heads; ``wk``/``wv`` whole), ``"gathered"`` (the query heads do not split
    but their ``H·hd`` columns do: the projections gathered whole, the
    attention whole on every rank), ``"whole"`` (nothing splits) or
    ``"none"`` (one model rank)."""
    H, K, hd, M = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, model_size
    if M == 1:
        return "none"
    if H % M:
        return "gathered" if H * hd % M == 0 else "whole"
    if K % M == 0:
        return "heads"
    return "head_dim" if K * hd % M == 0 else "kv_whole"


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device: torch.device, model_size: int = 1) -> KVCache:
    """A zeroed cache; ``S = min(max_len, window)`` when windowed; a rank's
    ``K / model_size`` KV heads, where only their columns split its
    ``hd / model_size`` slice of every head, else every head whole
    (:func:`gqa_layout`)."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    layout = gqa_layout(cfg, model_size)
    if layout == "head_dim":
        hd //= model_size
    elif layout == "heads":
        K //= model_size
    S = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, S, K, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def _layout(cfg: ModelConfig, tp) -> str:
    return gqa_layout(cfg, 1 if tp is None else tp.size("model"))


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


def _gathered(parts, tp):
    """The rank's column slices ``parts`` (each ``[B, T, c_i]``) whole over
    ``model``, by one gather (``gather_slices``: the work after it runs alike
    on every model rank, so the backward keeps the rank's slice)."""
    widths = [t.shape[-1] for t in parts]
    whole = gather_slices(torch.cat(parts, dim=-1)[..., None, :], tp, -2)
    return [t.flatten(-2) for t in whole.split(widths, dim=-1)]


def _project_qkv(p, x, cfg: ModelConfig, positions, tp=None):
    """q, k, v (k rotated) of ``x`` (before *f*) ``[B, T, *, hd]``: q of the
    rank's query heads (of every head where they are gathered or whole), k
    and v of its KV heads where they split, else of every KV head."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    layout = _layout(cfg, tp)
    if layout in ("none", "whole"):
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    else:
        xf = copy_to_model(x, tp)
        q = xf @ p["wq"]
        if layout == "head_dim":
            return (rope(q.unflatten(-1, (-1, hd)), positions, cfg.rope_theta),
                    *_kv_whole(p, xf, cfg, positions, tp))
        if layout == "heads":
            k, v = xf @ p["wk"], xf @ p["wv"]
        elif p["wk"].shape[-1] < cfg.num_kv_heads * hd:  # gathered, wk and wv split
            q, k, v = _gathered([q, xf @ p["wk"], xf @ p["wv"]], tp)
        else:
            # wk and wv whole: every rank's k and v are whole.  With the query
            # heads split, *f* on each sums over the ranks whose query heads
            # read it; gathered, every rank reads them alike.
            k, v = x @ p["wk"], x @ p["wv"]
            if layout == "kv_whole":
                k, v = copy_to_model(k, tp), copy_to_model(v, tp)
            else:
                q, = _gathered([q], tp)
    q, k, v = (t.unflatten(-1, (-1, hd)) for t in (q, k, v))
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _flash(q, k, v, cfg: ModelConfig, tp):
    if _layout(cfg, tp) in ("head_dim", "kv_whole"):
        k, v = (_read_heads(t, q.shape[2], cfg, tp).contiguous() for t in (k, v))
    return ops.flash_attention(q, k, v, cfg.causal, cfg.window, cfg.q_block, cfg.k_block)


def _out(p, out: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The attention's output ``[B, T, heads, hd]`` through ``wo``, whole:
    where the heads were gathered, first cut to the rank's columns
    (``slice_model``, whose backward gathers the gradient); *g* after ``wo``
    where its rows split."""
    B, T = out.shape[:2]
    out = out.reshape(B, T, -1)
    layout = _layout(cfg, tp)
    if layout in ("none", "whole"):
        return out @ p["wo"]
    if layout == "gathered":
        out = slice_model(out, tp, -1)
    return reduce_from_model(out @ p["wo"], tp)


def gqa_attention(p, x, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Training self-attention. x: [B, T, D] → [B, T, D].  ``tp``: the
    model axis (x before *f*; the output whole)."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    return _out(p, _flash(q, k, v, cfg, tp), cfg, tp)


def gqa_prefill(p, x, cfg: ModelConfig, cache: KVCache, tp=None):
    """Prefill: run attention AND fill ``cache`` in place (ring-buffered if
    windowed).  x: [B, T, D] → ([B, T, D], cache with length T)."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    out = _flash(q, k, v, cfg, tp)
    if _layout(cfg, tp) == "head_dim":
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
    return _out(p, out, cfg, tp), cache._replace(length=T)


def gqa_decode(p, x, cfg: ModelConfig, cache: KVCache, tp=None):
    """One decode step. x: [B, 1, D]; writes the new token's K/V into
    ``cache`` in place and returns ([B, 1, D], cache with length + 1).
    Under the head-dim split the cache is gathered whole over ``model`` for
    the rank's query heads (the module's docstring counts its bytes)."""
    B = x.shape[0]
    layout = _layout(cfg, tp)
    pos = cache.length  # absolute position of the new token
    ppos = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, ppos, tp)
    if layout == "head_dim":
        k, v = _cache_slice(k, tp), _cache_slice(v, tp)
    S = cache.k.shape[1]
    slot = pos % S if cfg.window > 0 else min(pos, S - 1)
    cache.k[:, slot].copy_(k[:, 0])
    cache.v[:, slot].copy_(v[:, 0])
    n_valid = min(pos + 1, S) if cfg.window > 0 else pos + 1
    kc, vc = cache.k, cache.v
    if layout == "head_dim":
        kc, vc = gather_model(torch.stack([kc, vc]), tp).unbind(0)
    if layout in ("head_dim", "kv_whole"):
        kc, vc = (_read_heads(t, q.shape[2], cfg, tp) for t in (kc, vc))
    out = decode_attention(q, kc, vc, n_valid)
    return _out(p, out, cfg, tp), cache._replace(length=pos + 1)


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


def _mla_tp(p, cfg: ModelConfig, tp):
    """``tp`` where the rank holds its own heads, None where the heads do not
    split over ``model`` (the up-projections whole: no *f* on the latents)."""
    return None if tp is None or p["w_uk"].shape[1] == cfg.num_heads else tp


def _mla_out(p, out: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The attention's output ``[B, T, heads, dv]`` through ``wo``, whole:
    *g* after ``wo``'s rows, which split with the heads or, the heads whole,
    with their ``H·dv`` columns (the output cut to the rank's columns first,
    ``slice_model``); no exchange where ``wo`` is whole."""
    B, T = out.shape[:2]
    out = out.reshape(B, T, -1)
    if tp is None or p["wo"].shape[0] == out.shape[-1] == cfg.num_heads * cfg.mla.v_head_dim:
        return out @ p["wo"]
    if out.shape[-1] > p["wo"].shape[0]:
        out = slice_model(out, tp, -1)
    return reduce_from_model(out @ p["wo"], tp)


def _mla_q(p, x, cfg: ModelConfig, positions, tp=None):
    """Queries of the heads that ``p`` holds; *f* on the input of their
    projection (``tp``: the model axis of a sharded mesh, where the rank
    holds its own heads)."""
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
    flash-attend; returns the block's output (whole) and the latents (c_kv,
    k_rope) that prefill caches."""
    B, T, _ = x.shape
    H, dr = p["w_uk"].shape[1], cfg.mla.rope_head_dim
    positions = torch.arange(T, device=x.device)[None, :]
    ftp = _mla_tp(p, cfg, tp)
    q_nope, q_rope = _mla_q(p, x, cfg, positions, ftp)
    c_kv, k_rope = _mla_latents(p, x, cfg, positions)
    ck, kr = copy_to_model(c_kv, ftp), copy_to_model(k_rope, ftp)
    # The kernel takes contiguous q, k, v: each concatenation is a new tensor,
    # with k_rope broadcast over the heads.
    k = torch.cat([_heads(ck, p["w_uk"]), kr[:, :, None, :].expand(B, T, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = _heads(ck, p["w_uv"])
    out = ops.flash_attention(q, k, v, cfg.causal, cfg.window, cfg.q_block, cfg.k_block,
                              _mla_scale(cfg))
    return _mla_out(p, out, cfg, tp), c_kv, k_rope


def mla_attention(p, x, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Training MLA. x: [B, T, D] (before *f*) → [B, T, D] (whole)."""
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
    q_nope, q_rope = _mla_q(p, x, cfg, ppos, _mla_tp(p, cfg, tp))
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
    return _mla_out(p, out, cfg, tp), cache._replace(length=pos + 1)
