"""Public kernel entry points, with the JAX package's positional signatures
and its autodiff design.

Port of ``repro/kernels/ops.py``.  A CUDA tensor goes to the Hopper kernel, a
CPU tensor to the plain PyTorch version in ``ref``; there is no fallback from
one to the other.  Each kernel is a ``torch.autograd.Function`` that saves
only its inputs and recomputes the backward through the autograd
of the plain version, as the reference's ``jax.custom_vjp`` takes the vjp of
its jnp oracle: no kernel output is kept as a residual, so the functions sit
safely inside ``torch.utils.checkpoint``.  :func:`prepare` builds and loads
ahead of time the kernels that a model's layers launch.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from . import build, ref
from .flash_attention import flash_attention_fwd
from .rglru_scan import rglru_scan_fwd

# The kernel that a layer of each kind launches on a CUDA tensor.
KERNEL_OF = {"attn": "flash_attention", "rec": "rglru_scan"}


def _flash_fwd(q, k, v, causal, window, scale):
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"no flash_attention path for device {q.device}")


def _scan_fwd(a, b, h0):
    if a.device.type == "cuda":
        return rglru_scan_fwd(a, b, h0)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    raise ValueError(f"no rglru_scan path for device {a.device}")


def _oracle_grads(fn, inputs, g):
    """Cotangents of ``fn`` at ``inputs`` (recomputed on detached copies)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        return torch.autograd.grad(fn(*xs), xs, g)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, scale)
        return _flash_fwd(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.mask
        oracle = lambda q, k, v: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, scale=scale)
        return (*_oracle_grads(oracle, ctx.saved_tensors, g), None, None, None)


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.save_for_backward(a, b, h0)
        return _scan_fwd(a, b, h0)

    @staticmethod
    def backward(ctx, g):
        return _oracle_grads(ref.rglru_scan_ref, ctx.saved_tensors, g)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: int = 0, q_block: int = 512, k_block: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention, q [B,Tq,H,dk], k/v [B,Tk,K,d*] → [B,Tq,H,dv].

    ``q_block``/``k_block`` are the reference's TPU tiling; the Hopper kernel
    chooses its own tiles, and the plain version needs none.
    """
    return _FlashAttention.apply(q, k, v, causal, window, scale)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t·h_{t-1} + b_t: a, b [B,T,W] fp32, h0 [B,W] fp32
    → h [B,T,W] fp32."""
    return _RGLRUScan.apply(a, b, h0)


def prepare(kinds: Iterable[str]) -> List[str]:
    """Build (one nvcc per stale source, in parallel) and load the kernels
    that layers of these kinds launch, so that no later launch waits on a
    build; return their names."""
    names = sorted({KERNEL_OF[k] for k in kinds})
    build.build(names)
    for name in names:
        build.load(name)
    return names
