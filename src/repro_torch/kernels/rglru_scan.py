"""RG-LRU scan on Hopper: the wrapper of ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``_rglru_kernel`` through ``rglru_scan_fwd``), with the same contract:
``h_t = a_t·h_{t-1} + b_t`` over a, b ``[B,T,W]`` fp32 from h0 ``[B,W]`` fp32,
returning h ``[B,T,W]`` fp32.

What bounds it on an H100: two FLOP per 12 bytes moved, so memory, and the
whole design is keeping enough bytes in flight.  One thread walks one
``(b, w)`` lane through time.  The ``"tma"`` variant feeds each block's
column of lanes from a ring of shared-memory stages that the TMA keeps full
(48 KB a block, its depth fixed in the source), so the bytes in flight no
longer depend on the number of lanes; the ``"lane"`` variant, for shapes the
TMA cannot address (:func:`variant`), issues its loads ahead into registers.  The source
file's header has the design and its bound.

:func:`rglru_scan_bwd` is the backward kernel in the same source: the
cotangents (da, db, dh0) of the reference's ``custom_vjp`` from a, the
forward's h, h0 and g = dL/dh, the recurrence run backwards in time (20 bytes
per element, so memory again), in the same two variants under the same rule.

The TPU tiling arguments (``t_block``/``w_block``) stay in the signature as
the reference's; the kernel chooses its own tiles and ignores them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_VARIANTS = {"lane": 0, "tma": 1}
# Time steps per stage of the tma variant's ring (csrc/rglru_scan.cu: ROWS).
ROWS = 64


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.rglru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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


def variant(*inputs: torch.Tensor) -> str:
    """The kernel variant a launch on these [B,T,W] fp32 inputs runs (the
    forward's a and b, or the backward's a, h and g; outputs are written
    from registers and need nothing).

    ``"tma"`` when the TMA can address every input: rows of a multiple of 16
    bytes (W % 4 == 0), 16-byte aligned storage, a non-empty tensor (a map
    has no zero extent), T with room for a stage past it in 32-bit
    coordinates and a batch stride under 2^40 bytes.  ``"lane"`` otherwise.
    This is the one place that states the rule; the C entry only refuses a
    tma request that breaks it.
    """
    B, T, W = inputs[0].shape
    tma = (B * T * W > 0 and W % 4 == 0 and T <= 2 ** 31 - 1 - 2 * ROWS
           and T * W * 4 < 2 ** 40 and all(x.data_ptr() % 16 == 0 for x in inputs))
    return "tma" if tma else "lane"


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
    kind = variant(a, b)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                                 B, T, W, _VARIANTS[kind], stream)
    build.raise_on(err, "rglru_scan")
    rglru_scan_fwd.launches += 1
    rglru_scan_fwd.launches_by_variant[kind] += 1
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
    kind = variant(a, h, g)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_bwd(a.data_ptr(), h.data_ptr(), h0.data_ptr(), g.data_ptr(),
                                 da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, T, W,
                                 _VARIANTS[kind], stream)
    build.raise_on(err, "rglru_scan backward")
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.launches_by_variant[kind] += 1
    return da, db, dh0


# Kernel launches since the last reset, in all and by variant.
rglru_scan_fwd.launches = 0
rglru_scan_fwd.launches_by_variant = dict.fromkeys(_VARIANTS, 0)
rglru_scan_bwd.launches = 0
rglru_scan_bwd.launches_by_variant = dict.fromkeys(_VARIANTS, 0)
