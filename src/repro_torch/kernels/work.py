"""The work of each kernel: its FLOPs and the HBM bytes it must move, and a
recorder of the work of the launches on the ``meta`` device.

One formula per kernel, read by the kernels' bounds (``chip_smoke.py``) and by
the dry run's roofline (``launch/dryrun.py``):

* flash attention's forward: 2 FLOP per multiply-add of QK^T (``dk``) and PV
  (``dv``) over the (query, key) pairs that the causal mask and the window
  keep (:func:`attn_pairs`: masked tiles are skipped); q, k, v read and the
  output written once, and the fp32 lse ``[B, H, Tq]`` where it is asked for;
* its backward: five products per kept pair (S, dP, dV, dK, dQ: 3 dk + 2 dv);
  q, k, v, the output, its cotangent and the lse read once, dq, dk, dv
  written once;
* the RG-LRU scan's forward: one fma (2 FLOP) per element; a and b read, h
  written, h0 read, in fp32; its backward: an add and two multiplies per
  element; g, a, h read, da and db written, h0 read and dh0 written.

On the ``meta`` device the kernels' entry points (``kernels/ops.py``) run no
operation that a FLOP counter could see: each adds its work to every
recorder open in :func:`recorded`.  Inside :func:`repeated` every count is
multiplied: a loop that runs one step on ``meta`` counts as its whole.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch

_RECORDERS: List[Dict] = []


def attn_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of one row and head that the mask keeps, as the
    kernels lay it: query ``i`` sees key ``j`` where ``j <= i`` (causal) and
    ``j > i - window`` (a window above 0)."""
    i = torch.arange(Tq, dtype=torch.int64)
    hi = torch.clamp(i, max=Tk - 1) if causal else torch.full_like(i, Tk - 1)
    lo = torch.clamp(i - window + 1, min=0) if window > 0 else torch.zeros_like(i)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def _bytes(shape, itemsize: int) -> int:
    n = itemsize
    for s in shape:
        n *= s
    return n


def flash_fwd_work(q, k, v, causal: bool, window: int, lse: bool = False) -> Tuple[int, int]:
    """(FLOPs, bytes) of flash attention's forward on q ``[B,Tq,H,dk]``, k
    ``[B,Tk,K,dk]``, v ``[B,Tk,K,dv]`` (tensors or shapes of ``q``'s
    dtype; ``itemsize`` from ``q`` where it is a tensor, else 2)."""
    B, Tq, H, dk = q.shape
    Tk, dv = k.shape[1], v.shape[3]
    size = q.element_size() if isinstance(q, torch.Tensor) else 2
    flops = 2 * (dk + dv) * B * H * attn_pairs(Tq, Tk, causal, window)
    nbytes = sum(_bytes(x.shape, size) for x in (q, k, v)) + _bytes((B, Tq, H, dv), size)
    return flops, nbytes + (_bytes((B, H, Tq), 4) if lse else 0)


def flash_bwd_work(q, k, v, causal: bool, window: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of flash attention's backward (shapes as in
    :func:`flash_fwd_work`)."""
    B, Tq, H, dk = q.shape
    Tk, dv = k.shape[1], v.shape[3]
    size = q.element_size() if isinstance(q, torch.Tensor) else 2
    flops = 2 * (3 * dk + 2 * dv) * B * H * attn_pairs(Tq, Tk, causal, window)
    qkv = sum(_bytes(x.shape, size) for x in (q, k, v))
    nbytes = 2 * qkv + 2 * _bytes((B, Tq, H, dv), size) + _bytes((B, H, Tq), 4)
    return flops, nbytes


def scan_fwd_work(a, h0) -> Tuple[int, int]:
    """(FLOPs, bytes) of the RG-LRU scan's forward: a, b, h ``[B,T,W]`` and
    h0 ``[B,W]``, fp32."""
    n, n0 = a.numel(), h0.numel()
    return 2 * n, 4 * (3 * n + n0)


def scan_bwd_work(a, h0) -> Tuple[int, int]:
    """(FLOPs, bytes) of the RG-LRU scan's backward."""
    n, n0 = a.numel(), h0.numel()
    return 3 * n, 4 * (5 * n + 2 * n0)


@contextlib.contextmanager
def recorded() -> Iterator[Dict]:
    """A record of the work of the kernels launched on ``meta`` inside the
    block: ``flops``, ``bytes`` and ``calls`` by kernel."""
    rec = {"flops": 0, "bytes": 0, "calls": {}}
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def record(name: str, work: Tuple[int, int]) -> None:
    """Add one launch of ``name`` and its (FLOPs, bytes) to every open record,
    :func:`repeats` times."""
    n = repeats()
    for rec in _RECORDERS:
        rec["flops"] += n * work[0]
        rec["bytes"] += n * work[1]
        rec["calls"][name] = rec["calls"].get(name, 0) + n


_REPEATS = [1]


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """Inside the block everything that a count sees (the dry run's FLOPs
    and HBM bytes, ``launch.roofline.StepCounter``, and the kernels' work)
    counts ``n`` times: one step of a loop run on ``meta`` stands for ``n``
    of them (the reference's dry run multiplies a loop body's counts by its
    trip count).  ``n`` 0: nothing is counted."""
    _REPEATS.append(_REPEATS[-1] * n)
    try:
        yield
    finally:
        _REPEATS.pop()


def repeats() -> int:
    """How many times what runs now counts (:func:`repeated`)."""
    return _REPEATS[-1]
