"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of ``repro/models/recurrent.py``.  Block: x → {linear branch → causal
depthwise conv(4) → RG-LRU}, gated by a parallel GeLU branch, then an output
projection.  The RG-LRU is a gated *linear* recurrence

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run the recurrence through ``kernels.ops.rglru_scan``
where the JAX package runs ``jax.lax.associative_scan`` with ``h0`` folded
into ``b[:, 0]``: both compute one recurrence from ``h0``.  On the card the
forward is the scan kernel and, in training, the backward the reverse-scan
kernel from the saved h (``rglru_scan_bwd``); on the CPU both are their plain
loops.
Decode is a one-step update in plain ops.  ``h`` and the carried conv inputs
stay fp32 in a bf16 model; the matmuls run in x's dtype.

Under tensor parallelism (``tp``, the model axis of a sharded mesh) a rank
runs its ``W/M`` channels: ``w_x``, ``w_gate``, ``conv_w`` and ``conv_b``
hold them (split on ``mlp``), so the branch, the gate and the causal conv
need no exchange.  ``w_a`` and ``w_i`` ``[W, W]`` hold the rank's *rows*:
the rank's products are partial sums over all ``W`` outputs, and one
reduce-scatter over ``model`` (``sharding.shard.reduce_scatter_model``)
carries both gates' partials to their sums on the rank's channels.  ``b_a``,
``b_i`` and ``lam``, whole on every model rank, are cut to those channels
(``slice_model``).  The scan runs on ``[B, T, W/M]``; ``w_out`` holds the
rank's rows, and *g* sums the block's output (*f* sits on its input).  The
state (:class:`RGLRUState`) holds the rank's channels, ``h [B, W/M]`` and
``conv [B, 3, W/M]``, where the reference's ``cache_pspecs`` replicates them
over ``model``: the rank's scan produces only its channels, and decode reads
only those.  Where W does not divide over ``model``, the rules leave every
weight of the block whole: the block then runs whole on every model rank,
with no *f* and no *g*, and its state is whole.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..sharding.shard import (copy_to_model, model_split, reduce_from_model,
                              reduce_scatter_model, slice_model)
from .specs import ParamSpec


def rglru_block_spec(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    g = cfg.rglru
    D = cfg.d_model
    W = g.width or D
    return {
        "w_x": ParamSpec((D, W), ("embed", "mlp"), dtype=dtype),
        "w_gate": ParamSpec((D, W), ("embed", "mlp"), dtype=dtype),
        "conv_w": ParamSpec((g.conv_width, W), (None, "mlp"), init="normal",
                            scale=0.1, dtype=dtype),
        "conv_b": ParamSpec((W,), ("mlp",), init="zeros", dtype=dtype),
        "w_a": ParamSpec((W, W), ("mlp", None), dtype=dtype),
        "b_a": ParamSpec((W,), (None,), init="zeros", dtype=dtype),
        "w_i": ParamSpec((W, W), ("mlp", None), dtype=dtype),
        "b_i": ParamSpec((W,), (None,), init="zeros", dtype=dtype),
        "lam": ParamSpec((W,), (None,), init="ones", dtype=torch.float32),
        "w_out": ParamSpec((W, D), ("mlp", "embed"), dtype=dtype),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor       # [B, W] recurrent state (fp32); a rank's [B, W/M]
    conv: torch.Tensor    # [B, conv_width-1, W] trailing inputs (fp32)


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.width or cfg.d_model


def rglru_state_spec(cfg: ModelConfig, batch: int, device: torch.device,
                     model_size: int = 1) -> RGLRUState:
    """A zeroed state of a rank's ``W / model_size`` channels (all ``W`` where
    they do not divide)."""
    g = cfg.rglru
    W = _width(cfg)
    W //= model_size if W % model_size == 0 else 1
    return RGLRUState(
        h=torch.zeros((batch, W), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, g.conv_width - 1, W), dtype=torch.float32, device=device),
    )


def _causal_conv(p, x: torch.Tensor, conv_width: int) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: [B, T, W]."""
    T = x.shape[1]
    out = x * p["conv_w"][conv_width - 1]
    for i in range(1, conv_width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :T]
        out = out + shifted * p["conv_w"][conv_width - 1 - i]
    return out + p["conv_b"]


def _gates(p, x: torch.Tensor, c: float, tp=None):
    """(a, b) of the scan on x's channels, each contiguous [B, T, W] fp32
    (under ``tp``, the rank's channels: the partial products reduce-scattered
    over ``model``)."""
    # The products run in x's dtype and are cast to fp32 after, as in the reference.
    if tp is None:
        ga, gi = x @ p["w_a"], x @ p["w_i"]
    else:
        both = torch.cat([x @ p["w_a"], x @ p["w_i"]], dim=-1)
        ga, gi = reduce_scatter_model(both, tp, -1, blocks=2).chunk(2, dim=-1)
    b_a, b_i, lam = (slice_model(p[k], tp) for k in ("b_a", "b_i", "lam"))
    r = torch.sigmoid(ga.float() + b_a.float())
    i = torch.sigmoid(gi.float() + b_i.float())
    log_a = -c * F.softplus(lam) * r           # [B, T, W] fp32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a.contiguous(), (beta * i * x.float()).contiguous()


def _tail_pad(z: torch.Tensor, n: int) -> torch.Tensor:
    T = z.shape[1]
    if T >= n:
        return z[:, T - n:]
    return F.pad(z, (0, 0, n - T, 0))


def rglru_block_with_state(
    p, x: torch.Tensor, cfg: ModelConfig, state: Optional[RGLRUState], tp=None
) -> Tuple[torch.Tensor, RGLRUState]:
    """x: [B, T, D] → ([B, T, D], state after the last token).  ``state=None``
    starts from zeros (prefill).  ``tp``: the model axis (x before *f*); the
    output whole."""
    g = cfg.rglru
    B, T, D = x.shape
    tp = model_split(tp, _width(cfg))
    x = copy_to_model(x, tp)
    W = p["w_x"].shape[-1]
    z = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")  # jax.nn.gelu's default form
    if state is not None:
        hist = torch.cat([state.conv.to(z.dtype), z], dim=1)
        zc = _causal_conv(p, hist, g.conv_width)[:, g.conv_width - 1:]
        h0 = state.h
        tail = hist[:, -(g.conv_width - 1):]
    else:
        zc = _causal_conv(p, z, g.conv_width)
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
        tail = _tail_pad(z, g.conv_width - 1)
    a, b = _gates(p, zc, g.c, tp)
    h = ops.rglru_scan(a, b, h0.contiguous())
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return reduce_from_model(out, tp), RGLRUState(h=h[:, -1], conv=tail.float())


def rglru_block(p, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Training forward (zero initial state). x: [B, T, D] → [B, T, D]."""
    return rglru_block_with_state(p, x, cfg, None, tp)[0]


def rglru_decode(p, x: torch.Tensor, cfg: ModelConfig, state: RGLRUState, tp=None):
    """One-token step. x: [B, 1, D] → ([B, 1, D], new state)."""
    g = cfg.rglru
    tp = model_split(tp, _width(cfg))
    x = copy_to_model(x, tp)
    z = x @ p["w_x"]                                               # [B, 1, W]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    hist = torch.cat([state.conv.to(z.dtype), z], dim=1)           # [B, cw, W]
    zc = torch.einsum("btw,tw->bw", hist, p["conv_w"]) + p["conv_b"]
    a, b = _gates(p, zc[:, None, :], g.c, tp)
    h = a[:, 0] * state.h + b[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return reduce_from_model(out, tp), RGLRUState(h=h, conv=hist[:, 1:].float())
