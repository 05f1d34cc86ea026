"""Flash-attention forward on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` through ``flash_attention_fwd``), with the same contract:
q ``[B,Tq,H,dk]``, k ``[B,Tk,K,dk]``, v ``[B,Tk,K,dv]`` → ``[B,Tq,H,dv]`` in
v's dtype, GQA by indexing KV head ``h // (H/K)``, causal / window / tail
masks, fp32 online softmax.

What bounds it on an H100: at both serving prefills (llama3.2-1b at d 64,
recurrentgemma-9b at d 256) attention does several hundred FLOP per byte of
q/k/v/o, above the card's ~295 FLOP/byte ridge, so the tensor cores bound it.
bf16 therefore takes the ``wgmma`` variant: TMA loads into a ring of
shared-memory stages, one producer warpgroup, two consumer warpgroups that
run both products on ``wgmma`` and keep P in registers between them, and KV
tiles that the causal or window mask empties are skipped.  fp32, and bf16
that the TMA cannot load, take the ``simt`` variant (CUDA cores, exact fp32
arithmetic).  :func:`variant` makes the choice, explicitly and never on a
failure; the source file's header has the tiling.

The TPU tiling arguments (``q_block``/``k_block``, 512/1024 by default) do not
fit Hopper's 227 KB of shared memory; the kernel picks its own tiles.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "wgmma": 1}
_MAX_HEAD_DIM = 256


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on q's device, got {x.device}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"q, k, v must share one dtype of {list(_DTYPES)}, "
                            f"got {q.dtype}/{k.dtype}/{v.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D [B,T,heads,d], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, _, H, dk = q.shape
    Bk, Tk, K, dkk = k.shape
    if Bk != B or dkk != dk or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"query heads {H} must be a multiple of KV heads {K}")
    for name, d in (("dk", dk), ("dv", v.shape[3])):
        if not 0 < d <= _MAX_HEAD_DIM:
            raise ValueError(f"{name}={d} outside 1..{_MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel variant a launch on these tensors runs.

    ``"wgmma"`` for bf16 that the TMA can load: dk and dv multiples of 8 (its
    strides are multiples of 16 bytes) and at most 256, from 16-byte aligned
    storage.  ``"simt"`` for fp32 and any other bf16.  This is the one place
    that states the rule; the C entry only refuses a wgmma request that
    breaks it.
    """
    dk, dv = q.shape[-1], v.shape[-1]
    tma = (q.dtype == torch.bfloat16 and dk % 8 == 0 and dv % 8 == 0
           and max(dk, dv) <= _MAX_HEAD_DIM
           and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    return "wgmma" if tma else "simt"


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; raise on anything it does not take."""
    _check(q, k, v, window)
    B, Tq, H, dk = q.shape
    _, Tk, K, dv = v.shape
    out = torch.empty((B, Tq, H, dv), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    scale = 1.0 / math.sqrt(dk) if scale is None else float(scale)
    kind = variant(q, k, v)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], _VARIANTS[kind], B, Tq, Tk, H, K, dk, dv,
            int(causal), int(window), scale, stream,
        )
    if err < 0:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_variant[kind] += 1
    return out


# Kernel launches since the last reset, in all and by variant.
flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_variant = dict.fromkeys(_VARIANTS, 0)
