"""Meshes of ranks over ``torch.distributed``, their collectives, and a
launcher of ranks on one host.

Port of ``repro/launch/mesh.py::make_mesh``.  A JAX mesh names axes over
devices that one program drives; here each device is driven by its own
process (a *rank*), and :func:`make_mesh` gives a rank what it needs to
take part: the axis sizes, its coordinates, its device, and its process
groups (:func:`group_spans`): one per axis of size above 1, one over the
whole world, and on a mesh of three axes above 1 the two that span two of
them: the pod's own ranks, ``data+model`` (the global norm's sum, the int8
scale's max, the MoE island over ``(data, model)``), and the rows,
``pod+data`` (the metrics' mean, serving's row gather).  Axes are ``pod``
(the slow, remote fabric), ``data`` and ``model`` (the fast, local ones).
Inside each pod, parameters are sharded by ``sharding/rules.py``: FSDP on
``data``, tensor parallelism on ``model`` (``sharding/shard.py``); the
rules never name ``pod``, so every pod holds the same blocks and a ``pod``
group joins the ranks that share their ``(data, model)`` coordinates
(``core/cohort.py`` reconciles them).

**Backends.**  Each group's backend is decided once, when the mesh is made,
from the topology that the ranks exchange (host name and device of each):
NCCL where every rank of the group has a GPU of its own; gloo on the CPU or
where ranks of the group share a GPU.  The mesh prints the choice.  A gloo
group given CUDA tensors stages them through pinned host buffers.

**Collectives** (:meth:`Mesh.all_reduce`, :meth:`Mesh.reduce_scatter`,
:meth:`Mesh.all_gather`, :meth:`Mesh.all_to_all`) run on 1-D tensors in slices of at most
:data:`CHUNK_ELEMENTS` elements, through the list forms of
``torch.distributed``'s calls.  Each call adds to :class:`Traffic` the
bytes it puts on its group, by ``core/asymmetry.py``'s formulas, and the
seconds it took between device synchronisations.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue
import socket
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.asymmetry import (all_gather_wire_bytes, all_to_all_wire_bytes,
                              allreduce_wire_bytes, reduce_scatter_wire_bytes)
from ..device import resolve_device

AXES = ("pod", "data", "model")
# The groups that span two axes, where both are above 1 and a third is too
# (else the pair spans the world): the pod's own ranks and the rows.
PAIRS = (("data", "model"), ("pod", "data"))
# The most elements one collective call moves (and one staging buffer holds):
# 2^26, 256 MB in fp32.
CHUNK_ELEMENTS = 2 ** 26
TIMEOUT = timedelta(seconds=300)


@dataclass
class Traffic:
    """What the collectives put on each group (``pod``, ``data``,
    ``model``, ``world``): calls, wire bytes per rank by ``asymmetry``'s formulas, and
    host seconds."""

    calls: Dict[str, int] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)

    def add(self, group: str, wire_bytes: float, seconds: float) -> None:
        self.calls[group] = self.calls.get(group, 0) + 1
        self.wire_bytes[group] = self.wire_bytes.get(group, 0.0) + wire_bytes
        self.seconds[group] = self.seconds.get(group, 0.0) + seconds

    def reset(self) -> None:
        self.calls.clear()
        self.wire_bytes.clear()
        self.seconds.clear()


def group_backend(members: Sequence[Tuple[str, str]]) -> str:
    """The backend of a group whose ranks run on ``members`` (host name,
    device): NCCL where every rank has a GPU of its own, else gloo."""
    own_gpus = (all(d.startswith("cuda") for _, d in members)
                and len(set(members)) == len(members))
    return "nccl" if own_gpus else "gloo"


@dataclass
class Mesh:
    """One rank's view of the mesh.  ``groups`` maps the names of
    :func:`group_spans` (``pod``, ``data``, ``model``, ``data+model``,
    ``pod+data``, ``world``) to this rank's process group; ``backends`` to
    their backends."""

    axes: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict)
    backends: Dict[str, str] = field(default_factory=dict)
    traffic: Traffic = field(default_factory=Traffic)
    _staging: Dict[Tuple[torch.dtype, int], torch.Tensor] = field(default_factory=dict,
                                                                 repr=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    def group_name(self, axes) -> str:
        """The group that spans ``axes`` (an axis name or a tuple of them):
        ``world`` for a tuple that holds every axis of size above 1, the
        axis for a tuple that holds one, a pair of :data:`PAIRS` by its
        name (``data+model``, ``pod+data``), ``self`` for one that holds
        none."""
        if isinstance(axes, str):
            return axes
        big = [a for a in self.axes if self.size(a) > 1]
        inside = tuple(a for a in AXES if a in axes and self.size(a) > 1)
        if set(big) <= set(axes):
            return "world"
        if not inside:
            return "self"  # this rank alone: no collective runs
        if len(inside) == 1:
            return inside[0]
        if inside in PAIRS:
            return "+".join(inside)
        raise ValueError(f"no group spans {axes} of mesh {self.shape}")

    def group_size(self, name: str) -> int:
        if name == "world":
            return self.world_size
        return 1 if name == "self" else math.prod(self.size(a) for a in name.split("+"))

    # ------------------------------------------------------- collectives --
    def _host(self, dtype: torch.dtype, slot: int, n: int) -> torch.Tensor:
        """A pinned host buffer of ``n`` elements (two slots per dtype); a
        normal tensor also when first asked for under ``inference_mode``
        (a serving step's collective), so that a later call outside it can
        write it."""
        buf = self._staging.get((dtype, slot))
        if buf is None or buf.numel() < n:
            with torch.inference_mode(False):
                buf = torch.empty(max(n, CHUNK_ELEMENTS), dtype=dtype, pin_memory=True)
            self._staging[(dtype, slot)] = buf
        return buf[:n]

    def _run(self, name: str, wire_bytes: float, body: Callable[[bool], None]) -> None:
        staged = self.device.type == "cuda" and self.backends[name] == "gloo"
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        body(staged)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.traffic.add(name, wire_bytes, time.perf_counter() - t0)

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """Reduce the 1-D ``t`` in place over the group of ``axes`` (``op``
        ``sum`` or ``max``); returns ``t``."""
        name = self.group_name(axes)
        a = self.group_size(name)
        if a == 1:
            return t
        group, rop = self.groups[name], {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def body(staged):
            for s in t.split(CHUNK_ELEMENTS):
                h = self._host(t.dtype, 0, s.numel()).copy_(s) if staged else s
                dist.all_reduce(h, op=rop, group=group)
                if staged:
                    s.copy_(h)

        self._run(name, allreduce_wire_bytes(t.numel() * t.element_size(), a), body)
        return t

    def reduce_scatter(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum the 1-D ``t`` over the group of ``axes`` and return this rank's
        ``1/a`` of it (piece ``i`` to the group's rank ``i``); ``t.numel()``
        must divide by the group's size ``a``."""
        name = self.group_name(axes)
        a = self.group_size(name)
        if a == 1:
            return t
        f = t.numel() // a
        if f * a != t.numel():
            raise ValueError(f"{t.numel()} elements do not split over {a} ranks")
        out = torch.empty(f, dtype=t.dtype, device=t.device)
        group, step = self.groups[name], max(CHUNK_ELEMENTS // a, 1)

        def body(staged):
            for lo in range(0, f, step):
                n = min(step, f - lo)
                pieces = [t[i * f + lo:i * f + lo + n] for i in range(a)]
                dst = out[lo:lo + n]
                if staged:
                    h = self._host(t.dtype, 0, a * n)
                    for i, p in enumerate(pieces):
                        h[i * n:(i + 1) * n].copy_(p)
                    pieces = list(h.split(n))
                    dst = self._host(t.dtype, 1, n)
                dist.reduce_scatter(dst, pieces, group=group)
                if staged:
                    out[lo:lo + n].copy_(dst)

        self._run(name, reduce_scatter_wire_bytes(t.numel() * t.element_size(), a), body)
        return out

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The 1-D ``t`` of every rank of the group of ``axes``, concatenated
        in the group's rank order."""
        name = self.group_name(axes)
        a = self.group_size(name)
        if a == 1:
            return t
        f = t.numel()
        out = torch.empty(a * f, dtype=t.dtype, device=t.device)
        group, step = self.groups[name], max(CHUNK_ELEMENTS // a, 1)

        def body(staged):
            for lo in range(0, f, step):
                n = min(step, f - lo)
                src = t[lo:lo + n]
                dsts = [out[i * f + lo:i * f + lo + n] for i in range(a)]
                if staged:
                    src = self._host(t.dtype, 0, n).copy_(src)
                    dsts = list(self._host(t.dtype, 1, a * n).split(n))
                dist.all_gather(dsts, src, group=group)
                if staged:
                    for i, d in enumerate(dsts):
                        out[i * f + lo:i * f + lo + n].copy_(d)

        self._run(name, all_gather_wire_bytes(a * f * t.element_size(), a), body)
        return out

    def all_to_all(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The 1-D ``t`` split into ``a`` equal pieces, piece ``i`` sent to the
        group's rank ``i``; returns the pieces received, in the group's rank
        order (``t.numel()`` must divide by the group's size ``a``)."""
        name = self.group_name(axes)
        a = self.group_size(name)
        if a == 1:
            return t
        f = t.numel() // a
        if f * a != t.numel():
            raise ValueError(f"{t.numel()} elements do not split over {a} ranks")
        out = torch.empty_like(t)
        group, step = self.groups[name], max(CHUNK_ELEMENTS // a, 1)

        def body(staged):
            if not staged:
                dist.all_to_all_single(out, t, group=group)
                return
            for lo in range(0, f, step):
                n = min(step, f - lo)
                h = self._host(t.dtype, 0, a * n)
                h.view(a, n).copy_(t.view(a, f)[:, lo:lo + n])
                dst = self._host(t.dtype, 1, a * n)
                dist.all_to_all_single(dst, h, group=group)
                out.view(a, f)[:, lo:lo + n].copy_(dst.view(a, n))

        self._run(name, all_to_all_wire_bytes(t.numel() * t.element_size(), a), body)
        return out


def _coords(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis, the ranks laid row-major."""
    coords, rest = {}, rank
    for ax in reversed(list(sizes)):
        coords[ax], rest = rest % sizes[ax], rest // sizes[ax]
    return {ax: coords[ax] for ax in sizes}


def group_spans(sizes: Dict[str, int]) -> Dict[str, Tuple[str, ...]]:
    """The groups that a mesh of ``sizes`` (axis -> size, in mesh order)
    builds, by name, each with the axes it spans: each axis of size above 1,
    each pair of :data:`PAIRS` whose axes are both above 1 on a mesh with a
    third above 1, and ``world``."""
    big = [a for a in sizes if sizes[a] > 1]
    spans = {a: (a,) for a in big}
    if len(big) == 3:
        spans.update({"+".join(pair): pair for pair in PAIRS})
    spans["world"] = tuple(sizes)
    return spans


def group_ranks(sizes: Dict[str, int], span: Sequence[str]) -> List[List[int]]:
    """Every group that spans ``span`` on a mesh of ``sizes``, in one order:
    the ranks that share all coordinates outside ``span``, in rank order."""
    groups: Dict[Tuple, List[int]] = {}
    for r in range(math.prod(sizes.values())):
        c = _coords(r, sizes)
        groups.setdefault(tuple(c[ax] for ax in sizes if ax not in span), []).append(r)
    return list(groups.values())


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None,
              timeout: timedelta = TIMEOUT) -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` over ``axes`` (of ``pod``,
    ``data``, ``model``).  Ranks lie row-major over the axes.  A mesh of more
    than one rank is made inside an initialised process group of as many
    ranks, by all of them.  ``device``: ``None`` for the CUDA card, where
    rank ``r`` takes ``cuda:(local_rank % device_count)`` (``LOCAL_RANK``,
    else the rank); ``"cpu"`` for the CPU."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or not set(axes) <= set(AXES):
        raise ValueError(f"mesh {shape} over {axes}: axes are distinct names of {AXES}")
    sizes = dict(zip(axes, shape))
    world = math.prod(shape)
    if world > 1 and not (dist.is_initialized() and dist.get_world_size() == world):
        raise RuntimeError(f"mesh {sizes} needs an initialised process group of {world} "
                           "ranks")
    rank = dist.get_rank() if world > 1 else 0
    coords = _coords(rank, sizes)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(axes=axes, shape=sizes, coords=coords, device=dev)
    if world == 1:
        return mesh

    topology: List[Any] = [None] * world
    dist.all_gather_object(topology, (socket.gethostname(), str(dev)))
    for name, span in group_spans(sizes).items():
        # Every group of this kind, in one order on every rank.
        for ranks in group_ranks(sizes, span):
            backend = group_backend([topology[r] for r in ranks])
            pg = dist.new_group(ranks, backend=backend, timeout=timeout)
            if rank in ranks:
                mesh.groups[name], mesh.backends[name] = pg, backend
                if rank == ranks[0]:
                    print(f"[mesh] {sizes}: group {name} of ranks {ranks} on "
                          f"{sorted({topology[r] for r in ranks})}: {backend}")
    return mesh


# ----------------------------------------------------------- launcher --
def _rank_main(rank, world, init, timeout, fn, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, world: int, args: Tuple = (), *,
                timeout: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` fresh processes (the ``spawn`` start
    method) joined in one gloo process group (``file://`` rendezvous in a
    private directory), each with one CPU thread for torch's own ops and
    ``LOCAL_RANK`` its rank.  Returns each rank's result in rank order:
    ``fn`` is a module-level function and its result is pickled (return
    numpy arrays, not tensors).  A rank that raises, or a run longer than
    ``timeout`` seconds, raises here; every process is stopped on return."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, timedelta(seconds=timeout), fn, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    lost = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
                    if lost:
                        raise RuntimeError(f"ranks {lost} exited with codes "
                                           f"{[procs[r].exitcode for r in lost]}")
                    if time.monotonic() >= deadline:
                        raise TimeoutError(f"{world - len(out)} of {world} ranks did not "
                                           f"finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [out[r] for r in range(world)]
