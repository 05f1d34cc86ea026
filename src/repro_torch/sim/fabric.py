"""Virtual-time RDMA fabric: the asymmetric memory with latency as charges.

The threaded benchmark injects fabric latency with ``time.sleep`` per remote
posting; here every operation instead **advances the virtual clock** by a
modeled cost, so a sweep's timeline is exact, deterministic, and free — the
wall clock never enters the simulated history.

The cost model prices what the hardware prices:

* a **local** register op costs ``local_op`` (cache-coherent access);
* an individually-posted remote op costs ``doorbell + wr`` (MMIO doorbell +
  one work request through the NIC);
* a :meth:`~repro_torch.core.AsymmetricMemory.post_batch` of N work requests costs
  ``doorbell + N*wr`` — the doorbell amortises, which is exactly what WR-list
  coalescing buys and what the threaded bench's per-posting sleep modeled.

The defaults keep the paper's ~10× local/remote asymmetry at the same 20 µs
remote-posting figure the threaded bench uses, so virtual throughputs land in
a comparable regime.

Faulty fabric
-------------

:class:`FabricFaults` turns the loss-free fabric into a lossy one, still
deterministic per seed.  Every remote *posting* passes a gate that can

* **drop** it (seeded Bernoulli, an armed ``fabric.drop`` injector point, a
  link **flap** window, a partition **cut**, or a **dead host**) — the poster
  discovers the loss at the op-level timeout (``op_timeout`` virtual seconds
  charged, ``OpCounts.timeouts`` incremented) and reposts on a seeded
  exponential-backoff schedule (``OpCounts.retries``);
* **delay** it (extra latency, nothing lost);
* **duplicate** it (the work request executes twice — reads and writes are
  idempotent, a duplicated CAS observes its own swap and no-ops, which is
  exactly why the lease word is CAS-only).

Loss classes differ in how they end:

* *random drops* end on a retry draw; past ``max_retries`` the op raises
  :class:`~repro_torch.core.RemoteTimeout` (the QP-retry-exhausted error);
* *flaps and partitions* have a scheduled heal time: the poster blocks,
  charging timeout+backoff rounds, until the window closes — an op in flight
  across a transient cut is late, not failed;
* *dead hosts* never heal: after ``max_retries`` rounds the op raises
  :class:`~repro_torch.core.RemoteTimeout`, which is how a home-host death becomes
  visible to its remote clients.

``probe`` (the failure-detector read) never blocks and never raises: one
timeout charge, then :data:`~repro_torch.core.memory.TIMEOUT`.
"""

from __future__ import annotations

import bisect
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core import AsymmetricMemory
from repro_torch.core.memory import TIMEOUT, RemoteTimeout

from .engine import SimEngine

__all__ = ["FabricFaults", "FabricLatency", "SimFabricMemory"]

_INF = float("inf")


@dataclass(frozen=True)
class FabricLatency:
    """Virtual seconds charged per operation component."""

    local_op: float = 2e-6    # machine-local register access
    doorbell: float = 20e-6   # one posting: MMIO write + NIC WR fetch
    wr: float = 1e-6          # per work request executed by the RNIC


class FabricFaults:
    """A seeded fault plan for :class:`SimFabricMemory`.

    All randomness comes from a dedicated stream keyed on ``seed`` (the run
    seed), so the same seed loses the same postings at the same arrivals —
    CI diffs two runs byte-for-byte.  ``injector`` optionally wires a
    :class:`~repro_torch.coord.FaultInjector` in, so one-shot ``fabric.drop`` /
    ``fabric.dup`` / ``fabric.delay`` triggers (and explicitly-labeled
    seeded storms) land on exact postings — that is how the crash matrix
    crosses host-crash cells with message-loss cells.

    ``flaps`` is a schedule of ``(host, start, end)`` windows during which
    every remote posting to or from ``host`` is lost; ``partitions`` is a
    schedule of ``(hosts, start, end)`` cuts during which postings crossing
    the ``hosts`` / non-``hosts`` boundary are lost.  Both heal at ``end``.
    ``fail_host`` marks a host's memory permanently unreachable from ``at``
    onward (home-host death).
    """

    def __init__(self, seed: int = 0, drop_prob: float = 0.0,
                 dup_prob: float = 0.0, delay_prob: float = 0.0,
                 extra_delay: float = 60e-6, op_timeout: float = 150e-6,
                 max_retries: int = 6, retry_base: float = 25e-6,
                 retry_cap: float = 400e-6,
                 flaps: Tuple[Tuple[int, float, float], ...] = (),
                 partitions: Tuple[Tuple[frozenset, float, float], ...] = (),
                 congest_capacity: Optional[int] = None,
                 congest_delay: float = 12e-6,
                 congest_window: float = 200e-6,
                 congest_cap: float = 800e-6,
                 injector=None):
        if op_timeout <= 0:
            raise ValueError("op_timeout must be positive")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.drop_prob = float(drop_prob)
        self.dup_prob = float(dup_prob)
        self.delay_prob = float(delay_prob)
        self.extra_delay = float(extra_delay)
        self.op_timeout = float(op_timeout)
        self.max_retries = int(max_retries)
        self.retry_base = float(retry_base)
        self.retry_cap = float(retry_cap)
        self.flaps = tuple(flaps)
        self.partitions = tuple(
            (frozenset(g), float(s), float(e)) for g, s, e in partitions)
        # Congestion model (off unless congest_capacity is set): each host
        # serves up to ``congest_capacity`` postings per ``congest_window``
        # for free; every posting beyond that queues ``congest_delay``
        # virtual seconds per excess op (capped at ``congest_cap``) — the
        # convex service-time curve that makes retry storms metastable.
        self.congest_capacity = (None if congest_capacity is None
                                 else int(congest_capacity))
        self.congest_delay = float(congest_delay)
        self.congest_window = float(congest_window)
        self.congest_cap = float(congest_cap)
        self.injector = injector
        self.dead: Dict[int, float] = {}  # host -> unreachable-from time
        self.stats = {"drops": 0, "dups": 0, "delays": 0, "probe_losses": 0,
                      "congested": 0}
        self._rng = random.Random(0x0FAB51C * (seed + 1))

    # ------------------------------------------------------------- schedule
    def fail_host(self, host: int, at: float) -> None:
        """Mark ``host``'s memory partition unreachable from ``at`` on."""
        self.dead[host] = min(float(at), self.dead.get(host, _INF))

    def cut_until(self, src: int, dst: int, now: float) -> Optional[float]:
        """Heal time of the widest cut between ``src`` and ``dst`` active at
        ``now`` — ``inf`` for a dead target, ``None`` when the path is up."""
        end = None
        if self.dead.get(dst, _INF) <= now:
            return _INF
        for host, s, e in self.flaps:
            if host in (src, dst) and s <= now < e:
                end = e if end is None else max(end, e)
        for group, s, e in self.partitions:
            if s <= now < e and (src in group) != (dst in group):
                end = e if end is None else max(end, e)
        return end

    # -------------------------------------------------------------- drawing
    def _point(self, label: str, pid: int) -> bool:
        inj = self.injector
        return inj is not None and inj.fabric_point(label, pid)

    def draw_drop(self, p, dst: int, now: float) -> Optional[float]:
        """None = delivered; else the heal time bound for this loss
        (``inf`` when only bounded retries apply)."""
        end = self.cut_until(p.node, dst, now)
        if end is not None:
            return end
        if self._point("fabric.drop", p.pid):
            return _INF
        if self.drop_prob and self._rng.random() < self.drop_prob:
            return _INF
        return None

    def draw_delay(self, p) -> bool:
        if self._point("fabric.delay", p.pid):
            return True
        return bool(self.delay_prob) and self._rng.random() < self.delay_prob

    def draw_dup(self, p) -> bool:
        if self._point("fabric.dup", p.pid):
            return True
        return bool(self.dup_prob) and self._rng.random() < self.dup_prob

    def backoff(self, attempt: int) -> float:
        """Seeded expo-backoff shape: doubling base, jitter, cap."""
        base = min(self.retry_base * (2.0 ** max(attempt - 1, 0)),
                   self.retry_cap)
        return base * (0.5 + self._rng.random())


class SimFabricMemory(AsymmetricMemory):
    """``AsymmetricMemory`` whose operation latencies charge a virtual clock.

    Plug the owning :class:`~repro_torch.sim.SimEngine` in and every register
    operation advances ``engine.clock`` by its modeled cost before executing.
    Semantics (Table-1 atomicity, per-class accounting, doorbell counting)
    are inherited unchanged — only *when* things happen becomes simulated.
    The engine's ``yield_point`` is installed as the spin hook so stray
    cross-task spins fail deterministically instead of hanging.

    Pass ``faults=FabricFaults(...)`` to make the fabric lossy (see the
    module docstring); without it every posting is delivered first try and
    the legacy timelines are byte-identical.
    """

    def __init__(self, num_nodes: int, engine: SimEngine,
                 latency: FabricLatency = FabricLatency(),
                 faults: Optional[FabricFaults] = None):
        super().__init__(
            num_nodes,
            sched=None,
            clock=engine.clock,
            yield_point=engine.yield_point,
        )
        self.engine = engine
        self.latency = latency
        self.faults = faults
        self._advance = engine.clock.advance
        # Per-host recent-posting times for the congestion model (sorted;
        # sim steps are atomic so no locking).  Only populated when the
        # fault plan prices congestion.
        self._load: Dict[int, List[float]] = {}

    # ----------------------------------------------------------- congestion
    def _congest(self, p, node: int) -> None:
        """Charge queueing delay for one delivered posting to ``node``.

        The host's observed load is the count of postings that reached it in
        the trailing ``congest_window``; every posting past
        ``congest_capacity`` queues ``congest_delay`` per excess op (capped).
        Purely a function of the event history, so two same-seed runs charge
        identical delays.  An armed ``fabric.congest`` injector point forces
        one congestion quantum onto a specific posting regardless of load.
        """
        f = self.faults
        if f is None or (f.congest_capacity is None and f.injector is None):
            return
        excess = 0
        if f.congest_capacity is not None:
            now = self.engine.clock.now
            q = self._load.setdefault(node, [])
            cutoff = now - f.congest_window
            drop = bisect.bisect_left(q, cutoff)
            if drop:
                del q[:drop]
            bisect.insort(q, now)
            excess = len(q) - f.congest_capacity
        if f._point("fabric.congest", p.pid):
            excess = max(excess, 1)
        if excess > 0:
            self._advance(min(excess * f.congest_delay, f.congest_cap))
            f.stats["congested"] += 1

    # ------------------------------------------------------------ fault gate
    def _remote_gate(self, p, node: int) -> bool:
        """Admit one remote posting from ``p`` to ``node``.

        Burns timeout+backoff rounds for every lost transmission (transient
        cuts block until their heal time; random losses and dead hosts raise
        :class:`RemoteTimeout` past ``max_retries``).  Returns whether the
        delivered posting is also duplicated.
        """
        f = self.faults
        if f is None:
            return False
        attempts = 0
        while True:
            heal = f.draw_drop(p, node, self.engine.clock.now)
            if heal is None:
                break
            # The posting is lost; the poster only learns at the op timeout.
            self._advance(f.op_timeout)
            p.counts.timeouts += 1
            f.stats["drops"] += 1
            attempts += 1
            if heal == _INF and attempts > f.max_retries:
                raise RemoteTimeout(
                    f"p{p.pid}@n{p.node} -> n{node}: remote posting lost "
                    f"{attempts} times (max_retries={f.max_retries})")
            self._advance(f.backoff(attempts))
            p.counts.retries += 1
        if f.draw_delay(p):
            self._advance(f.extra_delay)
            f.stats["delays"] += 1
        if f.draw_dup(p):
            f.stats["dups"] += 1
            return True
        return False

    # ---------------------------------------------------------- local charges
    def read(self, p, reg):
        self._advance(self.latency.local_op)
        return super().read(p, reg)

    def write(self, p, reg, value):
        self._advance(self.latency.local_op)
        super().write(p, reg, value)

    def cas(self, p, reg, expected, swap):
        self._advance(self.latency.local_op)
        return super().cas(p, reg, expected, swap)

    # --------------------------------------------------------- remote charges
    def rread(self, p, reg):
        dup = self._remote_gate(p, reg.node)
        self._congest(p, reg.node)
        self._advance(self.latency.doorbell + self.latency.wr)
        v = super().rread(p, reg)
        if dup:  # the retransmitted read executes again; same value, in-step
            self._advance(self.latency.wr)
        return v

    def rwrite(self, p, reg, value):
        dup = self._remote_gate(p, reg.node)
        self._congest(p, reg.node)
        self._advance(self.latency.doorbell + self.latency.wr)
        super().rwrite(p, reg, value)
        if dup:  # duplicated write re-applies the same value: idempotent
            self._advance(self.latency.wr)
            with reg._lock:
                reg._value = value

    def rcas(self, p, reg, expected, swap):
        dup = self._remote_gate(p, reg.node)
        self._congest(p, reg.node)
        self._advance(self.latency.doorbell + self.latency.wr)
        v = super().rcas(p, reg, expected, swap)
        if dup:
            # Duplicate delivery re-executes the compare-and-swap.  If the
            # first application succeeded, the duplicate observes the swap
            # and no-ops — the reason the lease word tolerates at-least-once
            # delivery is that every mutation is a CAS.
            self._advance(self.latency.wr)
            self._rcas_execute(reg, expected, swap)
        return v

    def post_batch(self, p, wrs):
        wrs = list(wrs)
        if not wrs:  # an empty posting rings no doorbell (and costs nothing)
            return super().post_batch(p, wrs)
        dup = self._remote_gate(p, wrs[0][1].node)
        self._congest(p, wrs[0][1].node)
        self._advance(self.latency.doorbell + self.latency.wr * len(wrs))
        out = super().post_batch(p, wrs)
        if dup:  # the WR list redelivers whole: reads/writes idempotent,
            self._advance(self.latency.wr * len(wrs))  # CASes observe swaps
            for wr in wrs:
                if wr[0] == "write":
                    with wr[1]._lock:
                        wr[1]._value = wr[2]
                elif wr[0] == "cas":
                    self._rcas_execute(wr[1], wr[2], wr[3])
        return out

    # ------------------------------------------------------------- probing
    def probe(self, p, reg):
        """Failure-detector read: give up after ONE op timeout, never block.

        A membership monitor must stay live while the probed host is not;
        a lost probe charges one timeout and returns
        :data:`~repro_torch.core.memory.TIMEOUT` for the suspicion estimator to
        count, instead of riding the retry schedule.
        """
        if p.is_local_to(reg):
            self._advance(self.latency.local_op)
            return super().read(p, reg)
        f = self.faults
        if f is not None:
            heal = f.cut_until(p.node, reg.node, self.engine.clock.now)
            if heal is None and f.drop_prob \
                    and f._rng.random() < f.drop_prob:
                heal = _INF
            if heal is not None:
                self._advance(f.op_timeout)
                p.counts.timeouts += 1
                f.stats["probe_losses"] += 1
                return TIMEOUT
        # Delivered first try: bypass the retry gate (a probe never reposts)
        # — but a congested host queues probes like any other posting, which
        # is exactly the latency signal the hedging threshold tracks.
        self._congest(p, reg.node)
        self._advance(self.latency.doorbell + self.latency.wr)
        return super().rread(p, reg)
