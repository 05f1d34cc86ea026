"""Simulated RDMA shared-memory with *operation asymmetry* (paper §2, Table 1).

The paper models an RDMA system as nodes ``N``, processes ``P`` and a shared
memory ``M`` partitioned among nodes into atomic 8-byte registers.  A process
is *local* to a register iff it resides on the register's node.  Each class of
access supports ``{read, write, cas}``; atomicity *between* the classes follows
Table 1 of the paper:

==============  ======  ======  =====
local \\ remote  rRead   rWrite  rRMW
==============  ======  ======  =====
Read            atomic  atomic  atomic
Write           atomic  atomic  NOT
RMW             atomic  atomic  NOT
==============  ======  ======  =====

i.e. a remote RMW (``rCAS``) executed by the RNIC appears to the *local*
memory subsystem as an unordered read-then-write, so it can lose updates
against a concurrent local ``CAS``/``Write``.

This module reproduces those semantics exactly so the lock algorithms built on
top are exercised under the same hazards they were designed for:

* local RMW holds the register's *machine* lock for the whole read-modify-write
  (cache-coherence atomicity);
* remote RMW is serialised against other remote RMWs by a per-node *RNIC*
  lock, but its read and write phases take the machine lock separately with a
  preemption point in between — the Table-1 hazard;
* plain reads/writes (either class) are single-register atomic (8B in a cache
  line).

The memory also *accounts* every operation per process and class, which is how
the benchmarks verify the paper's cost claims (local processes: 0 RDMA ops;
lone remote acquire: 1 rCAS; queued remote acquire: +1 rWrite; unlock: at most
rCAS + rWrite).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

NULLPTR = None  # the paper's ``nullptr`` sentinel for pointer-valued registers


class OperationNotEnabled(RuntimeError):
    """Raised when a process uses an operation not enabled for it (paper §2)."""


class RemoteTimeout(RuntimeError):
    """A remote posting exceeded its op-level timeout budget.

    Raised by fabrics that model message loss (``repro_torch.sim.fabric``) once the
    bounded retransmit schedule is exhausted — the RDMA analogue of a QP
    transitioning to error after ``retry_cnt`` retries.  The plain in-memory
    fabric never raises it.
    """


class DeadlineExceeded(TimeoutError):
    """An operation's caller-supplied deadline expired before completion.

    Deadlines are absolute instants on the stack's injected clock: every
    public lock-table operation accepts one, threads it through its retry
    loops, and clamps each backoff sleep to the remaining budget — so an op
    fails *fast* at its deadline instead of sleeping past the point where
    the answer is useless.  Subclasses :class:`TimeoutError` so callers that
    treat all patience exhaustion alike (e.g. the batch suffix-rollback
    path) need no new handler.
    """


class Overloaded(RuntimeError):
    """A fast **local** refusal from the overload-protection layer.

    Raised before any remote posting when proceeding would be wasted work:
    the destination host's circuit breaker is open, its retry budget is
    exhausted, or the shard's observed service time makes the caller's
    deadline infeasible (a shed).  Costs zero RDMA operations — the whole
    point is that refusing locally removes retry traffic from a fabric that
    is already drowning.  ``reason`` is one of ``"breaker"``, ``"budget"``,
    ``"shed"``.
    """

    def __init__(self, msg: str, reason: str = "shed", host: int = -1):
        super().__init__(msg)
        self.reason = reason
        self.host = host


class _TimeoutSentinel:
    """Falsy singleton returned by :meth:`AsymmetricMemory.probe` on loss."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "TIMEOUT"

    def __bool__(self) -> bool:
        return False


TIMEOUT = _TimeoutSentinel()


@dataclass
class OpCounts:
    """Per-process operation accounting (the unit of the paper's cost claims).

    ``remote_*`` count RDMA *completions* (one per work request, the unit of
    the paper's cost claims); ``remote_doorbell`` counts *postings* — a
    :meth:`AsymmetricMemory.post_batch` of N work requests rings the doorbell
    once and completes N times, which is how doorbell coalescing shows up in
    the telemetry (completions unchanged, postings collapsed).
    """

    local_read: int = 0
    local_write: int = 0
    local_cas: int = 0
    remote_read: int = 0
    remote_write: int = 0
    remote_cas: int = 0
    remote_doorbell: int = 0
    # Faulty-fabric accounting: a ``timeout`` is one lost posting discovered
    # at its op-level deadline; a ``retry`` is one backoff-scheduled repost.
    # Both are zero on a loss-free fabric (the failure-free path costs
    # nothing, per Dhoked & Mittal's adaptive-recovery bar).
    timeouts: int = 0
    retries: int = 0

    @property
    def rdma_ops(self) -> int:
        return self.remote_read + self.remote_write + self.remote_cas

    @property
    def local_ops(self) -> int:
        return self.local_read + self.local_write + self.local_cas

    def as_tuple(self) -> tuple:
        """O(1) allocation-light snapshot for per-op accounting hot paths."""
        return (
            self.local_read, self.local_write, self.local_cas,
            self.remote_read, self.remote_write, self.remote_cas,
            self.remote_doorbell, self.timeouts, self.retries,
        )

    def add_since(self, current: "OpCounts", since: tuple) -> None:
        """Accumulate ``current - since`` into self, in place (no allocs).

        ``since`` is an :meth:`as_tuple` snapshot taken before the operation;
        this is the O(1) telemetry-accounting path (the old per-op
        ``snapshot()``/``delta()`` pair built two dicts and two dataclass
        instances per table operation).
        """
        self.local_read += current.local_read - since[0]
        self.local_write += current.local_write - since[1]
        self.local_cas += current.local_cas - since[2]
        self.remote_read += current.remote_read - since[3]
        self.remote_write += current.remote_write - since[4]
        self.remote_cas += current.remote_cas - since[5]
        self.remote_doorbell += current.remote_doorbell - since[6]
        self.timeouts += current.timeouts - since[7]
        self.retries += current.retries - since[8]

    def snapshot(self) -> "OpCounts":
        return OpCounts(**vars(self))

    def delta(self, since: "OpCounts") -> "OpCounts":
        return OpCounts(**{k: getattr(self, k) - getattr(since, k) for k in vars(self)})

    def __add__(self, other: "OpCounts") -> "OpCounts":
        return OpCounts(**{k: getattr(self, k) + getattr(other, k) for k in vars(self)})


class Register:
    """An atomic 8-byte register residing in one node's memory partition."""

    __slots__ = ("name", "node", "_value", "_lock")

    def __init__(self, name: str, node: int, value: Any):
        self.name = name
        self.node = node
        self._value = value
        # The "machine" lock: models cache-coherence atomicity on the owning
        # node.  Local RMW holds it across the full read-modify-write.
        self._lock = threading.Lock()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Register({self.name}@n{self.node}={self._value!r})"


@dataclass
class Process:
    """A process ``p_i^j`` — node id, process id and its operation counters."""

    pid: int
    node: int
    counts: OpCounts = field(default_factory=OpCounts)

    def is_local_to(self, reg: Register) -> bool:
        return self.node == reg.node


def _thread_yield() -> None:
    """Default ``yield_point``: release the GIL so another thread can run."""
    time.sleep(0)


class AsymmetricMemory:
    """RDMA-accessible shared memory ``M`` partitioned among nodes.

    ``sched`` is an optional preemption hook invoked at every operation
    boundary (and *inside* the non-atomic window of ``rcas``); the stress tests
    install a randomised yield to explore interleavings.

    ``clock``/``yield_point`` are the virtual-time hooks: every piece of the
    stack that waits (lock spin loops, the Peterson wait, the baselines)
    routes its wait step through ``yield_point`` instead of calling
    ``time.sleep(0)`` directly, and time-based logic reads ``clock``.  The
    defaults preserve threaded behavior exactly (a GIL-releasing yield and
    ``time.monotonic``); the discrete-event engine (``repro_torch.sim``) installs a
    virtual clock and a spin hook that charges simulated time, which is how
    the same lock code runs unmodified under simulation.
    """

    def __init__(
        self,
        num_nodes: int,
        sched: Optional[Callable[[], None]] = None,
        clock: Optional[Callable[[], float]] = None,
        yield_point: Optional[Callable[[], None]] = None,
    ):
        self.num_nodes = num_nodes
        self._registers: Dict[str, Register] = {}
        self._rnic_locks = [threading.Lock() for _ in range(num_nodes)]
        self._sched = sched or (lambda: None)
        self.clock = clock or time.monotonic
        self.yield_point = yield_point or _thread_yield
        self._pid_counter = itertools.count()
        self._reg_guard = threading.Lock()

    # ------------------------------------------------------------------ setup
    def spawn(self, node: int) -> Process:
        if not (0 <= node < self.num_nodes):
            raise ValueError(f"node {node} out of range")
        return Process(pid=next(self._pid_counter), node=node)

    def alloc(self, node: int, name: str, value: Any = NULLPTR) -> Register:
        if not (0 <= node < self.num_nodes):
            raise ValueError(f"node {node} out of range")
        with self._reg_guard:
            if name in self._registers:
                raise ValueError(f"register {name!r} already allocated")
            reg = Register(name, node, value)
            self._registers[name] = reg
            return reg

    # -------------------------------------------------------------- local ops
    def read(self, p: Process, reg: Register) -> Any:
        self._require_local(p, reg, "Read")
        self._sched()
        with reg._lock:
            v = reg._value
        p.counts.local_read += 1
        return v

    def write(self, p: Process, reg: Register, value: Any) -> None:
        self._require_local(p, reg, "Write")
        self._sched()
        with reg._lock:
            reg._value = value
        p.counts.local_write += 1

    def cas(self, p: Process, reg: Register, expected: Any, swap: Any) -> Any:
        """Local CAS: atomic read-modify-write under the machine lock."""
        self._require_local(p, reg, "CAS")
        self._sched()
        with reg._lock:
            observed = reg._value
            if observed == expected:
                reg._value = swap
        p.counts.local_cas += 1
        return observed

    # ------------------------------------------------------------- remote ops
    # Each individually-posted remote op rings its own doorbell (one WR, one
    # posting); ``post_batch`` is the coalesced path (one doorbell, N WRs).
    def rread(self, p: Process, reg: Register) -> Any:
        self._sched()
        with reg._lock:  # 8B remote read is atomic w.r.t. local ops (Table 1)
            v = reg._value
        p.counts.remote_read += 1
        p.counts.remote_doorbell += 1
        return v

    def rwrite(self, p: Process, reg: Register, value: Any) -> None:
        self._sched()
        with reg._lock:  # 8B remote write is atomic w.r.t. local read/write
            reg._value = value
        p.counts.remote_write += 1
        p.counts.remote_doorbell += 1

    def _rcas_execute(self, reg: Register, expected: Any, swap: Any) -> Any:
        """The RNIC's compare-and-swap, shared by ``rcas`` and ``post_batch``.

        Serialised against *other remote RMWs* by the RNIC lock, but its read
        and write phases acquire the machine lock separately with a
        preemption point in between — i.e. **not** atomic w.r.t. local
        ``CAS``/``Write`` (the Table-1 hazard: to a local process an ``rCAS``
        appears as a Read then a Write).
        """
        with self._rnic_locks[reg.node]:
            with reg._lock:
                observed = reg._value
            # RNIC compare happens outside the machine's coherence domain: a
            # local CAS/Write can slip in right here.  The tagged hook lets
            # tests interleave this window deterministically.
            try:
                self._sched("rcas_window")
            except TypeError:
                self._sched()
            if observed == expected:
                with reg._lock:
                    reg._value = swap
        return observed

    def rcas(self, p: Process, reg: Register, expected: Any, swap: Any) -> Any:
        """Remote CAS, executed by the target node's RNIC (see _rcas_execute)."""
        self._sched()
        observed = self._rcas_execute(reg, expected, swap)
        p.counts.remote_cas += 1
        p.counts.remote_doorbell += 1
        return observed

    # ------------------------------------------------------ doorbell batching
    def post_batch(self, p: Process, wrs) -> list:
        """Post a list of remote work requests with **one doorbell** (WR list).

        Models RDMA doorbell batching: a verbs client chains several work
        requests and rings the QP doorbell once, so N operations cost one
        posting (one MMIO/doorbell, one NIC fetch) and N completions.  The
        accounting mirrors that: ``remote_doorbell`` is incremented once,
        the per-op completion counters (``remote_read``/``remote_write``/
        ``remote_cas``) by N — the paper's per-op cost claims are stated over
        completions and are unchanged by coalescing.

        ``wrs`` is a sequence of tuples::

            ("read",  reg)                   -> result: the value read
            ("write", reg, value)            -> result: None
            ("cas",   reg, expected, swap)   -> result: the observed value

        Constraints, matching the hardware: every register must live on the
        same node (a WR list targets one queue pair), and the poster must be
        *remote* to that node — local processes touch their own memory
        directly and have no doorbell to ring (use plain ``read``/``write``/
        ``cas``).

        Atomicity is per work request, identical to posting each op alone:
        reads/writes are single-register atomic, and each CAS keeps the
        Table-1 non-atomic window w.r.t. local ``CAS``/``Write``.  The WR
        list as a whole is **not** atomic — other processes can interleave
        between its entries.
        """
        wrs = list(wrs)
        if not wrs:
            return []
        # Validate the whole list before touching any register: a malformed
        # WR must not leave earlier entries applied-but-unaccounted.  Arity
        # is checked before any element access so a short tuple surfaces as
        # the documented ValueError, not an IndexError.
        _ARITY = {"read": 2, "write": 3, "cas": 4}
        for wr in wrs:
            if not wr or _ARITY.get(wr[0]) != len(wr):
                raise ValueError(f"malformed work request {wr!r}")
        node = wrs[0][1].node
        for wr in wrs:
            if wr[1].node != node:
                raise ValueError(
                    f"post_batch spans nodes {node} and {wr[1].node}: a work-"
                    "request list targets one queue pair (one node)"
                )
        if p.node == node:
            raise OperationNotEnabled(
                f"process p{p.pid}@n{p.node} posted a doorbell batch to "
                "its own node; local processes access memory directly"
            )
        results = []
        nread = nwrite = ncas = 0
        self._sched()  # the single doorbell ring
        for i, wr in enumerate(wrs):
            op, reg = wr[0], wr[1]
            if i:  # entries execute in order but are NOT mutually atomic:
                self._sched()  # let stress schedulers interleave between WRs
            if op == "read":
                with reg._lock:
                    results.append(reg._value)
                nread += 1
            elif op == "write":
                with reg._lock:
                    reg._value = wr[2]
                results.append(None)
                nwrite += 1
            elif op == "cas":
                results.append(self._rcas_execute(reg, wr[2], wr[3]))
                ncas += 1
        p.counts.remote_read += nread
        p.counts.remote_write += nwrite
        p.counts.remote_cas += ncas
        p.counts.remote_doorbell += 1
        return results

    # ------------------------------------------------------ dispatch helpers
    def auto_read(self, p: Process, reg: Register) -> Any:
        """Read with the cheapest *enabled* operation (paper §2 locality)."""
        return self.read(p, reg) if p.is_local_to(reg) else self.rread(p, reg)

    def auto_write(self, p: Process, reg: Register, value: Any) -> None:
        if p.is_local_to(reg):
            self.write(p, reg, value)
        else:
            self.rwrite(p, reg, value)

    def auto_cas(self, p: Process, reg: Register, expected: Any, swap: Any) -> Any:
        if p.is_local_to(reg):
            return self.cas(p, reg, expected, swap)
        return self.rcas(p, reg, expected, swap)

    def probe(self, p: Process, reg: Register) -> Any:
        """Bounded-liveness read: the value, or :data:`TIMEOUT` on loss.

        Failure detectors must not block on the very host they are probing,
        so this read gives up instead of retrying.  On the plain in-memory
        fabric delivery is reliable and ``probe`` is exactly ``auto_read``;
        lossy fabrics (``repro_torch.sim.fabric``) override it to return
        :data:`TIMEOUT` after one op-level timeout when the target is
        unreachable (dead host, link flap, partition cut).
        """
        return self.auto_read(p, reg)

    def fence(self, p: Process) -> None:
        """RDMA + local memory fence.

        The per-op locking above already yields sequentially-consistent
        register operations (every op is an acquire/release pair on the
        machine lock), matching the paper's assumption that programmers insert
        the required fences; this is the explicit no-op hook for symmetry.
        """
        self._sched()

    # --------------------------------------------------------------- internal
    def _require_local(self, p: Process, reg: Register, op: str) -> None:
        if not p.is_local_to(reg):
            raise OperationNotEnabled(
                f"process p{p.pid}@n{p.node} attempted local {op} on remote "
                f"register {reg.name!r}@n{reg.node}; remote processes are "
                "constrained to remote accesses (operation asymmetry, paper §2)"
            )


def make_scheduler(rng, p_yield: float = 0.3) -> Callable[[], None]:
    """A randomised preemption hook for stress tests.

    With probability ``p_yield`` the calling thread sleeps 0 seconds, which
    releases the GIL and lets the OS scheduler pick another runnable thread —
    cheap, wall-clock-free interleaving diversity.
    """

    def sched() -> None:
        if rng.random() < p_yield:
            time.sleep(0)

    return sched
