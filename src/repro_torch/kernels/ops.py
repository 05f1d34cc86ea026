"""Public kernel entry points, with the JAX package's positional signatures
and its autodiff design.

Port of ``repro/kernels/ops.py``.  A CUDA tensor goes to the Hopper kernel, a
CPU tensor to the plain PyTorch version in ``ref``; there is no fallback from
one to the other.  Each kernel is a ``torch.autograd.Function`` with the
reference's ``jax.custom_vjp`` contract: the same function and the same
cotangents, up to rounding.

Flash attention's forward also returns each row's log-sum-exp when a
gradient is wanted, and saves q, k, v, its output and that lse; its backward
is the flash-backward kernel on CUDA (``flash_attention_bwd``) and the same
equations in plain PyTorch on the CPU (``ref.flash_attention_bwd_ref``).
Under non-reentrant ``torch.utils.checkpoint`` (the models' remat) the
saved output and lse are those of the recomputed forward, so saving them is
safe there.  The RG-LRU scan saves a, h0 and its output h (never b, which
the backward does not need), likewise the recomputed forward's h under
remat; its backward is the reverse-scan kernel on CUDA
(``rglru_scan_bwd``) and the same loop in plain PyTorch on the CPU
(``ref.rglru_scan_bwd_ref``), the cotangents of the reference's oracle vjp.
:func:`prepare` builds and loads ahead of time the kernels that a model's
layers launch.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from . import build, ref
from .flash_attention import flash_attention_bwd, flash_attention_fwd
from .rglru_scan import rglru_scan_bwd, rglru_scan_fwd

# The kernel that a layer of each kind launches on a CUDA tensor (None: the
# xLSTM blocks run as PyTorch ops and launch none of this package's kernels).
KERNEL_OF = {"attn": "flash_attention", "rec": "rglru_scan", "mlstm": None, "slstm": None}


def _flash_fwd(q, k, v, causal, window, scale, lse=False):
    """The output, or (output, lse) with ``lse``."""
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale, lse=lse)
    if q.device.type == "cpu":
        fn = ref.flash_attention_lse_ref if lse else ref.flash_attention_ref
        return fn(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"no flash_attention path for device {q.device}")


def _flash_bwd(q, k, v, out, lse, g, causal, window, scale):
    """(dq, dk, dv) from the forward's output and lse."""
    if q.device.type == "cuda":
        return flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window,
                                   scale=scale)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal,
                                           window=window, scale=scale)
    raise ValueError(f"no flash_attention backward for device {q.device}")


def _scan_fwd(a, b, h0):
    if a.device.type == "cuda":
        return rglru_scan_fwd(a, b, h0)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    raise ValueError(f"no rglru_scan path for device {a.device}")


def _scan_bwd(a, h, h0, g):
    """(da, db, dh0) from a, the forward's output h and h0."""
    if a.device.type == "cuda":
        return rglru_scan_bwd(a, h, h0, g)
    if a.device.type == "cpu":
        return ref.rglru_scan_bwd_ref(a, h, h0, g)
    raise ValueError(f"no rglru_scan backward for device {a.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, grad):
        ctx.mask = (causal, window, scale)
        if not grad:  # no graph will be recorded: no lse, nothing saved
            return _flash_fwd(q, k, v, causal, window, scale)
        out, lse = _flash_fwd(q, k, v, causal, window, scale, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.mask
        return (*_flash_bwd(*ctx.saved_tensors, g, causal, window, scale),
                None, None, None, None)


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan_fwd(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        return _scan_bwd(a, h, h0, g.contiguous())


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: int = 0, q_block: int = 512, k_block: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention, q [B,Tq,H,dk], k/v [B,Tk,K,d*] → [B,Tq,H,dv].

    ``q_block``/``k_block`` are the reference's TPU tiling; the Hopper kernel
    chooses its own tiles, and the plain version needs none.
    """
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, window, scale, grad)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t·h_{t-1} + b_t: a, b [B,T,W] fp32, h0 [B,W] fp32
    → h [B,T,W] fp32."""
    return _RGLRUScan.apply(a, b, h0)


def prepare(kinds: Iterable[str]) -> List[str]:
    """Build (one nvcc per stale source, in parallel) and load the kernels
    that layers of these kinds launch, so that no later launch waits on a
    build; return their names (none for kinds without a kernel)."""
    names = sorted({KERNEL_OF[k] for k in kinds} - {None})
    build.build(names)
    for name in names:
        build.load(name)
    return names
