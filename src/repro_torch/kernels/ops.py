"""Public kernel entry points, with the JAX package's positional signatures.

Port of ``repro/kernels/ops.py``.  A CUDA tensor goes to the Hopper kernel, a
CPU tensor to the plain PyTorch version in ``ref``; there is no fallback from
one to the other.  Forward only: backward and training are later work.
:func:`prepare` builds and loads ahead of time the kernels that a model's
layers launch.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from . import build, ref
from .flash_attention import flash_attention_fwd
from .rglru_scan import rglru_scan_fwd

# The kernel that a layer of each kind launches in prefill on a CUDA tensor.
KERNEL_OF = {"attn": "flash_attention", "rec": "rglru_scan"}


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: int = 0, q_block: int = 512, k_block: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention, q [B,Tq,H,dk], k/v [B,Tk,K,d*] → [B,Tq,H,dv].

    ``q_block``/``k_block`` are the reference's TPU tiling; the Hopper kernel
    chooses its own tiles, and the plain version needs none.
    """
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"no flash_attention path for device {q.device}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t·h_{t-1} + b_t: a, b [B,T,W] fp32, h0 [B,W] fp32
    → h [B,T,W] fp32."""
    if a.device.type == "cuda":
        return rglru_scan_fwd(a, b, h0)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    raise ValueError(f"no rglru_scan path for device {a.device}")


def prepare(kinds: Iterable[str]) -> List[str]:
    """Build (one nvcc per stale source, in parallel) and load the kernels
    that layers of these kinds launch, so that no later launch waits on a
    build; return their names."""
    names = sorted({KERNEL_OF[k] for k in kinds})
    build.build(names)
    for name in names:
        build.load(name)
    return names
