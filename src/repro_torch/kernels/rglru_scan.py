"""RG-LRU scan on Hopper: the wrapper of ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``_rglru_kernel`` through ``rglru_scan_fwd``), with the same contract:
``h_t = a_t·h_{t-1} + b_t`` over a, b ``[B,T,W]`` fp32 from h0 ``[B,W]`` fp32,
returning h ``[B,T,W]`` fp32.

What bounds it on an H100: two FLOP per 12 bytes moved, so memory.  One
thread walks one ``(b, w)`` lane through time with its loads issued ahead of
the fmas; the source file's header has the design and its limit.

The TPU tiling arguments (``t_block``/``w_block``) stay in the signature as
the reference's; the kernel needs no tiles and ignores them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}; want [B,T,W], [B,T,W], [B,W]")
    named = (("a", a), ("b", b), ("h0", h0))
    for name, x in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in named:
        if x.device.type != "cuda" or x.device != a.device:
            raise ValueError(f"{name} must be a CUDA tensor on a's device, got {x.device}")


def rglru_scan_fwd(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
    t_block: int = 256, w_block: int = 512,
) -> torch.Tensor:
    """Launch the kernel on the current stream; raise on anything it does not take."""
    _check(a, b, h0)
    B, T, W = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                                 B, T, W, stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0  # kernel launches since the last reset
