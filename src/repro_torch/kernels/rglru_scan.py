"""RG-LRU scan on Hopper: the wrapper of ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``_rglru_kernel`` through ``rglru_scan_fwd``), with the same contract:
``h_t = a_t·h_{t-1} + b_t`` over a, b ``[B,T,W]`` fp32 from h0 ``[B,W]`` fp32,
returning h ``[B,T,W]`` fp32.

What bounds it on an H100: two FLOP per 12 bytes moved, so memory.  One
thread walks one ``(b, w)`` lane through time with its loads issued ahead of
the fmas; the source file's header has the design and its limit.

:func:`rglru_scan_bwd` is the backward kernel in the same source: the
cotangents (da, db, dh0) of the reference's ``custom_vjp`` from a, the
forward's h, h0 and g = dL/dh, the recurrence run backwards in time (20 bytes
per element, so memory again).

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
    fn = lib.rglru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(h0: torch.Tensor, **seqs: torch.Tensor) -> None:
    """Each of ``seqs`` (``a`` first) [B,T,W] and h0 [B,W], all fp32,
    contiguous and on a's CUDA device."""
    a = seqs["a"]
    named = (*seqs.items(), ("h0", h0))
    if (a.dim() != 3 or h0.shape != (a.shape[0], a.shape[2])
            or any(x.shape != a.shape for x in seqs.values())):
        raise ValueError("shape mismatch: " + ", ".join(f"{n} {tuple(x.shape)}" for n, x in named)
                         + "; want [B,T,W] and h0 [B,W]")
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
    _check(h0, a=a, b=b)
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


def rglru_scan_bwd(
    a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor, g: torch.Tensor,
):
    """(da, db, dh0) of ``h = rglru_scan_fwd(a, b, h0)`` for the cotangent
    ``g`` of h, from a, that h and h0 (b is not needed).  Launches on the
    current stream; raises on anything the kernel does not take."""
    _check(h0, a=a, h=h, g=g)
    B, T, W = a.shape
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    if da.numel() == 0:
        return da, db, dh0.zero_()
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_bwd(a.data_ptr(), h.data_ptr(), h0.data_ptr(), g.data_ptr(),
                                 da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, T, W, stream)
    if err:
        raise RuntimeError(f"rglru_scan backward kernel launch failed: cudaError {err}")
    rglru_scan_bwd.launches += 1
    return da, db, dh0


# Kernel launches since the last reset.
rglru_scan_fwd.launches = 0
rglru_scan_bwd.launches = 0
