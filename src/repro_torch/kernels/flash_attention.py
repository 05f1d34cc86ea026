"""Flash attention on Hopper, forward and backward: the wrapper of
``csrc/flash_attention.cu``.

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

The ``wgmma`` variant is instantiated at four widths (DK for q and k, DV
for v and o), and :func:`widths` names the one a shape runs: (64, 64),
(128, 128) and (256, 256) for head dims up to 64, 128 and 256, and
(192, 128) for MLA's dk 192 / dv 128 (any 128 < dk <= 192 with dv <= 128).
The TMA zero-fills dk and dv up to DK and DV, and every product runs that
wide.  What bounds each on an H100: the tensor cores at every width;
at (64, 64) the softmax's exponentials as much as the products.  At
(256, 256) the forward holds 64 keys a tile (O's accumulator takes 128
registers a thread).  At (192, 128) Q and K span three 64-column swizzle
atoms and V two: O is 64 registers, with 64 keys a tile as at (256, 256)
(the source's ``WgmmaTile`` says why not 128), in 214160 B of shared memory
(Q 48 KB, four stages of K 24 KB and V 16 KB), and its blocks walk each
head's query tiles together, so that the head's K and V stay in L2 (MLA
gives every head its own); zero-filled to (256, 256) instead, MLA ran 512
product columns a pair where it needs 320.

The forward writes each row's log-sum-exp when asked (fp32 ``[B,H,Tq]``,
natural-log units of the scaled scores, -inf for a row with no unmasked
key).  :func:`flash_attention_bwd` computes (dq, dk, dv) from it and the
forward's output with the flash-backward equations, on the tensor cores for
every bf16 shape the forward's ``wgmma`` rule takes, at the same widths:
``flash_bwd_wgmma`` at (64, 64) and (128, 128) (dq summed in fp32 by bulk
reductions whose order across blocks can change from run to run), and past
them ``flash_bwd_wgmma_dkdv`` and ``flash_bwd_wgmma_dq`` (dK and dV of each
head group to fp32 partials that one pass sums in a fixed order, dq
recomputed per query tile: no atomics, deterministic).  At (256, 256) those
split the head dim across two consumer warpgroups; at (192, 128) each
consumer holds whole rows (dK 96 and dV 64 registers a thread for 64 keys,
beside the scores of 32 queries at a time; or dQ 96 for 64 queries), and
with one head group the dkdv kernel casts dk and dv itself.  ``flash_bwd_simt`` takes
everything else (CUDA cores, exact fp32, no atomics, deterministic);
:func:`variant` makes that choice too.  The reference has no backward
kernel: its ``custom_vjp`` takes the oracle's vjp, which this computes up to
rounding.

The TPU tiling arguments (``q_block``/``k_block``, 512/1024 by default) do not
fit Hopper's 227 KB of shared memory; the kernel picks its own tiles.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "wgmma": 1}
_MAX_HEAD_DIM = 256
MAX_FUSED_BWD_DIM = 128  # flash_bwd_wgmma<64>, <128>; past it, flash_bwd_wgmma_dkdv / _dq
# The wgmma instantiations (DK, DV), as the C entries take them.
WIDTHS = ((64, 64), (128, 128), (192, 128), (256, 256))
_ROWS = 64  # the backward's query tile (t_pad in the .cu): per-row buffers are padded to it


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 14 + [ctypes.c_float,
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
    """The kernel variant a launch of the forward or the backward on these
    tensors runs.

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


def widths(dk: int, dv: int) -> Tuple[int, int]:
    """The widths (DK, DV) of the ``wgmma`` instantiation that runs a shape
    of head dims dk (q, k) and dv (v), forward and backward: (192, 128) for
    128 < dk <= 192 with dv <= 128 (MLA's 192 / 128), else (D, D) for the
    smallest D of 64, 128 and 256 that covers max(dk, dv).  The TMA
    zero-fills dk and dv to DK and DV.  A rule of the shape alone, stated
    here once; the C entries refuse widths that do not cover dk and dv."""
    if 128 < dk <= 192 and dv <= 128:
        return 192, 128
    d = max(dk, dv)
    if not 0 < d <= _MAX_HEAD_DIM:
        raise ValueError(f"no wgmma instantiation covers dk {dk}, dv {dv}")
    d = next(w for w in (64, 128, 256) if d <= w)
    return d, d


def bwd_groups(B: int, K: int, Tk: int, group: int, sms: int) -> int:
    """Blocks that share one (64-key tile, KV head) in the backward past head
    dim 128: the smallest divisor of the GQA group ``group`` (= H/K) that
    gives at least three blocks per SM, or the whole group.  At B 1 and one
    KV head a grid of key tiles alone leaves most of the card idle, and
    whole blocks of unequal causal work balance better the more there are;
    each group adds one fp32 copy of dK and dV to sum."""
    tiles = B * K * -(-Tk // _ROWS)
    return next((n for n in range(1, group + 1) if group % n == 0 and tiles * n >= 3 * sms),
                group)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
    lse: bool = False,
):
    """Launch the kernel on the current stream; raise on anything it does not
    take.  Returns the output, or (output, lse) with ``lse``."""
    _check(q, k, v, window)
    B, Tq, H, dk = q.shape
    _, Tk, K, dv = v.shape
    out = torch.empty((B, Tq, H, dv), dtype=v.dtype, device=v.device)
    row_lse = torch.empty((B, H, Tq), dtype=torch.float32, device=v.device) if lse else None
    if out.numel() == 0:
        return (out, row_lse) if lse else out
    scale = 1.0 / math.sqrt(dk) if scale is None else float(scale)
    kind = variant(q, k, v)
    wdk, wdv = widths(dk, dv) if kind == "wgmma" else (0, 0)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            row_lse.data_ptr() if lse else None,
            _DTYPES[q.dtype], _VARIANTS[kind], wdk, wdv, B, Tq, Tk, H, K, dk, dv,
            int(causal), int(window), scale, stream,
        )
    build.raise_on(err, "flash_attention")
    _count(flash_attention_fwd, kind, wdk, wdv)
    return (out, row_lse) if lse else out


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
):
    """(dq, dk, dv) of flash attention from the forward's output and lse
    (``flash_attention_fwd(..., lse=True)``) and the output's cotangent.
    Launches on the current stream; raises on anything it does not take."""
    _check(q, k, v, window)
    B, Tq, H, dk = q.shape
    _, Tk, K, dv = v.shape
    if out.shape != (B, Tq, H, dv) or dout.shape != out.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be "
                         f"{(B, Tq, H, dv)}")
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, H, Tq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    for name, x in (("out", out), ("lse", lse), ("dout", dout)):
        if x.device != q.device:
            raise ValueError(f"{name} must be on q's device {q.device}, got {x.device}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out and dout must be {q.dtype}, got {out.dtype}/{dout.dtype}")
    # Autograd's cotangent may be a strided view; the TMA reads it from a
    # contiguous, 16-byte aligned copy.
    out, lse, dout = out.contiguous(), lse.contiguous(), dout.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    dq, dk_, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk_.numel() == 0:
        return dq.zero_(), dk_.zero_(), dv_.zero_()
    scale = 1.0 / math.sqrt(dk) if scale is None else float(scale)
    kind = variant(q, k, v)
    wdk, wdv = widths(dk, dv) if kind == "wgmma" else (0, 0)
    # Per-row D = rowsum(dout * out) and lse in base 2, padded to whole
    # query tiles.  The wgmma variant's fp32 scratch: up to width 128, dq's
    # sums, [B,H,t_pad,dk] so that each query tile of a head is one contiguous
    # run; past it, each head group's dK and then dV, [groups,B,Tk,K,d]
    # (none at (192, 128) with one group: its kernel casts dk and dv itself).
    t_pad = -(-Tq // _ROWS) * _ROWS
    rows = torch.empty((2, B, H, t_pad), dtype=torch.float32, device=q.device)
    scratch, groups = None, 1
    if kind == "wgmma" and wdk <= MAX_FUSED_BWD_DIM:
        scratch = torch.zeros((B, H, t_pad, dk), dtype=torch.float32, device=q.device)
    elif kind == "wgmma":
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        groups = bwd_groups(B, K, Tk, H // K, sms)
        if groups > 1 or wdk == wdv:
            scratch = torch.empty(groups * B * Tk * K * (dk + dv), dtype=torch.float32,
                                  device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            rows[0].data_ptr(), rows[1].data_ptr(),
            _DTYPES[q.dtype], _VARIANTS[kind], wdk, wdv, B, Tq, Tk, H, K, dk, dv,
            int(causal), int(window), groups, scale, stream,
        )
    build.raise_on(err, "flash_attention backward")
    _count(flash_attention_bwd, kind, wdk, wdv)
    return dq, dk_, dv_


def _count(fn, kind: str, wdk: int, wdv: int) -> None:
    fn.launches += 1
    fn.launches_by_variant[kind] += 1
    if kind == "wgmma":
        fn.launches_by_widths[f"{wdk}x{wdv}"] += 1


# Kernel launches since the last reset, in all, by variant and, on wgmma, by
# the widths of the instantiation, "DKxDV" (a backward launch is one call:
# its row pass, its main kernels and the last pass that casts dq, or sums
# and casts dk and dv).
for _fn in (flash_attention_fwd, flash_attention_bwd):
    _fn.launches = 0
    _fn.launches_by_variant = dict.fromkeys(_VARIANTS, 0)
    _fn.launches_by_widths = dict.fromkeys((f"{a}x{b}" for a, b in WIDTHS), 0)
