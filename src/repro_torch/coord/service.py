"""Coordination service: the sharded asymmetric lock table plus the named
locks, elections and barriers the training control plane is built from.

This is where the paper's primitive earns its keep inside the framework.  A
multi-host training job has exactly the asymmetry the paper models: one host
*owns* a given coordination record (the checkpoint manifest, the membership
epoch — "local" class, fast access), every other host reaches it over the
fabric ("remote" class).  Using ALock means the owning host's control loop
never pays a fabric round-trip, remote hosts pay a small bounded number of
one-sided ops, and the budget guarantees neither class starves the other —
precisely the paper's design goals, applied to checkpoint-writer election and
elastic-membership barriers.

Two tiers of API:

* **Lock table** (:class:`~repro_torch.coord.table.ShardedLockTable`, delegated via
  ``try_acquire`` / ``acquire`` / ``acquire_batch`` / ``release`` / ``renew``
  / ``telemetry``): the scalable path.  The keyspace is sharded over all
  hosts so *every* host is the zero-RDMA local class for its slice, leases
  expire so a crashed holder cannot wedge a shard, and fencing tokens let
  downstream stores reject a dead holder's stale writes.
* **Named locks** (``lock`` / ``elect`` / :class:`Barrier`): small fixed sets
  of control-plane records pinned to an explicit home host — the original
  one-record-per-lock shape, kept for the handful of singleton records
  (membership epoch, barrier generations) where explicit placement beats
  hashed placement.

Hosts are simulated by threads over :class:`repro_torch.core.AsymmetricMemory`; on a
real deployment the same algorithm runs over RDMA verbs (the memory API is the
paper's register model).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from ..core import ALock, AsymmetricMemory, OpCounts, Process

from .faults import FaultInjector
from .inflation import InflationPolicy
from .ledger import LedgerStore, RecoverableClient
from .membership import HostMembership, SuspicionPolicy
from .overload import OverloadPolicy
from .pipeline import AsyncClient
from .table import Lease, LeaseMode, ShardedLockTable


class CoordinationService:
    """Sharded lock table + named ALocks + election + barriers."""

    def __init__(
        self,
        num_hosts: int,
        init_budget: int = 4,
        num_shards: Optional[int] = None,
        sched=None,
        clock=None,
        sleep=None,
        yield_point=None,
        fault: Optional[FaultInjector] = None,
        inflation: Optional[InflationPolicy] = None,
        seed: int = 0,
        overload: Optional[OverloadPolicy] = None,
    ):
        self.num_hosts = num_hosts
        # One time source end-to-end: the memory's spin hooks, the table's
        # lease deadlines and the barriers' timeouts all read the same
        # injected clock (and back off through the matching sleep/yield),
        # so the whole service runs unchanged under the sim engine's
        # virtual time.
        self.mem = AsymmetricMemory(
            num_hosts, sched=sched, clock=clock, yield_point=yield_point
        )
        self.table = ShardedLockTable(
            self.mem, num_shards=num_shards, init_budget=init_budget,
            clock=clock, sleep=sleep, name="svc.table", fault=fault,
            inflation=inflation, seed=seed, overload=overload,
        )
        # Durable lease ledgers, keyed by client NAME (the identity that
        # survives a crash) — the restart re-entry API below hands a
        # restarted client its predecessor's ledger to replay.
        self.ledgers = LedgerStore()
        self._locks: Dict[str, ALock] = {}
        self._claims: Dict[str, object] = {}
        self._init_budget = init_budget
        self._guard = threading.Lock()
        # Read-mostly lease cache: (holder pid, key, mode) -> latest Lease.
        # The table's renewal/release fast path CASes the expiry register
        # against the lease's (token, expires_at) witness, so a caller
        # holding a *stale* lease object (e.g. the one acquire returned,
        # after several keepalives) would fall off the fast path.  The cache
        # keeps the freshest witness per holder and substitutes it when the
        # fencing token matches — repeat holders skip the slow ALock
        # transaction (and its table lookups) entirely.  The key includes
        # the lease *mode*: a shared lease and an exclusive lease on the
        # same key are different grants with different witnesses (and a
        # mid-upgrade holder briefly has both).  Entries are dropped on
        # release or any failed renew; leases that silently lapse (a crashed
        # holder never calls back) are swept inside _cache_put once the
        # cache grows past an amortised threshold, so it cannot leak
        # unboundedly.
        self._lease_cache: Dict[tuple, Lease] = {}
        self._cache_sweep_at = self._CACHE_SWEEP

    _CACHE_SWEEP = 1024

    def _cache_put(self, p: Process, lease: Lease) -> None:
        cache = self._lease_cache
        if len(cache) >= self._cache_sweep_at:
            now = self.table.clock()
            # Keep anything not yet a full TTL past expiry: a just-expired
            # witness can still serve the slow path's diagnosis.
            stale = [k for k, l in list(cache.items())
                     if now >= l.expires_at + l.ttl]
            for k in stale:
                cache.pop(k, None)
            # Amortise: next sweep only after the surviving (live) set could
            # have doubled, so steady-state puts stay O(1) even with >1024
            # live leases (a sweep that evicts nothing doesn't rerun per put).
            self._cache_sweep_at = max(self._CACHE_SWEEP, 2 * len(cache))
        cache[(p.pid, lease.key, lease.mode)] = lease

    def host_process(self, host: int) -> Process:
        """One coordination process per host (call once per host thread)."""
        return self.mem.spawn(host)

    # ------------------------------------------------------------ lock table
    def shard_of(self, key: str) -> int:
        return self.table.shard_of(key)

    def home_of(self, key: str) -> int:
        return self.table.home_of(key)

    def try_acquire(self, p: Process, key: str, ttl: float,
                    mode: LeaseMode = LeaseMode.EXCLUSIVE) -> Optional[Lease]:
        lease = self.table.try_acquire(p, key, ttl, mode=mode)
        if lease is not None:
            self._cache_put(p, lease)
        return lease

    def acquire(self, p: Process, key: str, ttl: float,
                timeout: Optional[float] = None,
                mode: LeaseMode = LeaseMode.EXCLUSIVE,
                deadline: Optional[float] = None,
                priority: int = 0) -> Lease:
        lease = self.table.acquire(p, key, ttl, timeout=timeout, mode=mode,
                                   deadline=deadline, priority=priority)
        self._cache_put(p, lease)
        return lease

    def acquire_batch(self, p: Process, keys: Sequence[str], ttl: float,
                      timeout: Optional[float] = None,
                      mode: LeaseMode = LeaseMode.EXCLUSIVE,
                      deadline: Optional[float] = None) -> List[Lease]:
        leases = self.table.acquire_batch(p, keys, ttl, timeout=timeout,
                                          mode=mode, deadline=deadline)
        for lease in leases:
            self._cache_put(p, lease)
        return leases

    def _freshest(self, p: Process, lease: Lease, evict: bool) -> Lease:
        """Substitute the cached latest witness for the same grant."""
        ck = (p.pid, lease.key, lease.mode)
        cached = self._lease_cache.get(ck)
        if cached is not None and cached.token == lease.token:
            # Same grant: use the freshest witness (keeps the CAS fast path
            # hot).  A token mismatch is an older grant's stale object —
            # leave the live grant's cache entry alone.
            if evict:
                self._lease_cache.pop(ck, None)
            return cached
        return lease

    def release(self, p: Process, lease: Lease,
                deadline: Optional[float] = None) -> bool:
        return self.table.release(p, self._freshest(p, lease, evict=True),
                                  deadline=deadline)

    def release_batch(self, p: Process, leases: Sequence[Lease]) -> int:
        """Witness-corrected batch release, shard-grouped by the table
        (one doorbell per shard group of fast-path CASes, at most one
        ALock critical section per group for the slow-path remainder)."""
        fixed = [self._freshest(p, lease, evict=True) for lease in leases]
        return self.table.release_batch(p, fixed)

    def renew(self, p: Process, lease: Lease,
              ttl: Optional[float] = None,
              deadline: Optional[float] = None) -> Optional[Lease]:
        """Renew via the table's fast path, witness-corrected by the cache.

        A stale lease *object* (same fencing token, older ``expires_at``) is
        silently refreshed to the cached latest before the CAS, so repeat
        holders stay on the zero-ALock fast path no matter which of their
        lease objects they pass in.  A token mismatch is never refreshed —
        that is a different grant and must fail fencing validation.
        """
        lease = self._freshest(p, lease, evict=False)
        renewed = self.table.renew(p, lease, ttl, deadline=deadline)
        if renewed is None:
            self._lease_cache.pop((p.pid, lease.key, lease.mode), None)
        else:
            self._cache_put(p, renewed)
        return renewed

    def upgrade(self, p: Process, lease: Lease,
                ttl: Optional[float] = None) -> Optional[Lease]:
        """SHARED → EXCLUSIVE via the table (sole live reader only); the
        cache swaps the shared entry for the new exclusive grant."""
        lease = self._freshest(p, lease, evict=False)
        upgraded = self.table.upgrade(p, lease, ttl)
        if upgraded is not None:
            self._lease_cache.pop((p.pid, lease.key, lease.mode), None)
            self._cache_put(p, upgraded)
        return upgraded

    def downgrade(self, p: Process, lease: Lease,
                  ttl: Optional[float] = None) -> Optional[Lease]:
        """EXCLUSIVE → SHARED via the table's single-CAS transition; the
        cache swaps the exclusive entry for the new shared grant."""
        lease = self._freshest(p, lease, evict=False)
        downgraded = self.table.downgrade(p, lease, ttl)
        if downgraded is not None:
            self._lease_cache.pop((p.pid, lease.key, lease.mode), None)
            self._cache_put(p, downgraded)
        return downgraded

    # --------------------------------------------------- optimistic read path
    def read_optimistic(self, p: Process, key: str,
                        deadline: Optional[float] = None):
        """Lease-free seqlock read of ``key``'s published payload: 0 RDMA
        for home readers, one doorbell (4 rREADs, 0 CAS) for remote
        readers.  Returns ``(value, publish_token)``; falls back to a
        transient shared lease after bounded instability."""
        return self.table.read_optimistic(p, key, deadline=deadline)

    def publish(self, p: Process, lease: Lease, value,
                deadline: Optional[float] = None) -> bool:
        """Fenced publish of ``value`` under a live EXCLUSIVE ``lease`` so
        optimistic readers can observe it (witness-corrected first, so a
        stale lease object still fences correctly)."""
        return self.table.publish(p, self._freshest(p, lease, evict=False),
                                  value, deadline=deadline)

    def async_client(self, p: Process, flush_ops: int = 8,
                     quantum: float = 100e-6) -> AsyncClient:
        """A per-process futures pipeline over the table: enqueues remote
        ops per destination host and flushes one ``post_batch`` posting per
        scheduling quantum (hedged probes from ``p`` ride its
        flushes)."""
        return AsyncClient(self.table, p, flush_ops=flush_ops,
                           quantum=quantum)

    def note_renewed(self, p: Process, lease: Lease,
                     renewed: Optional[Lease]) -> None:
        """Lease-cache maintenance for a renew performed *outside*
        :meth:`renew` — e.g. one that rode an :class:`AsyncClient` flush.
        Keeps later witness-checked releases on the fast path."""
        if renewed is None:
            self._lease_cache.pop((p.pid, lease.key, lease.mode), None)
        else:
            self._cache_put(p, renewed)

    # -------------------------------------------------------- crash recovery
    def reclaim(self, p: Process, lease: Lease,
                ttl: Optional[float] = None,
                deadline: Optional[float] = None) -> Optional[Lease]:
        """Crash-restart re-entry for one lease (see the table's docstring);
        a successful reclaim primes the cache with the fresh witness."""
        got = self.table.reclaim(p, lease, ttl, deadline=deadline)
        if got is not None:
            self._cache_put(p, got)
        else:
            self._lease_cache.pop((p.pid, lease.key, lease.mode), None)
        return got

    def recoverable(self, name: str, p: Process) -> RecoverableClient:
        """A ledger-writing lease client under the durable identity
        ``name``.  First start of an identity; after a crash, use
        :meth:`restart` instead."""
        return RecoverableClient(self.table, p, self.ledgers.ledger(name))

    def restart(self, name: str, p: Process
                ) -> tuple:
        """Crash-restart re-entry for the client identity ``name``: rebind
        its ledger to the new incarnation ``p``, replay it, and reclaim
        every still-valid lease.  Returns ``(client, reclaimed)``; the
        reclaimed leases are primed into the lease cache."""
        client = RecoverableClient(self.table, p, self.ledgers.ledger(name))
        reclaimed = client.restart(p)
        for lease in reclaimed:
            self._cache_put(p, lease)
        return client, reclaimed

    # --------------------------------------------------- failover / takeover
    def membership(self, host: int,
                   policy: Optional[SuspicionPolicy] = None,
                   ) -> HostMembership:
        """This host's membership agent: its heartbeat lease (ledgered under
        the durable identity ``member.h<host>``, so member shards survive
        takeovers with their fencing intact), its suspicion estimator, and
        the partition-guard attestation.  One per host."""
        return HostMembership(
            self.table, self.mem, host, self.num_hosts, policy=policy,
            ledger=self.ledgers.ledger(f"member.h{host}"))

    def takeover_shard(self, p: Process, shard_index: int,
                       membership: Optional[HostMembership] = None,
                       fence_slack: int = 16) -> Optional[Dict[str, int]]:
        """Epoch-fenced takeover of ``shard_index`` onto ``p``'s host,
        rebuilt from the merged stream of ALL ledgers in the service's
        store (see :meth:`ShardedLockTable.takeover_shard`)."""
        return self.table.takeover_shard(
            p, shard_index, self.ledgers.all_records(),
            membership=membership, fence_slack=fence_slack)

    def shards_homed_on(self, host: int) -> List[int]:
        """The shard indices currently homed on ``host`` (a takeover's
        work list when ``host`` is declared dead)."""
        return [s.index for s in self.table.shards if s.home_host == host]

    def telemetry(self) -> List[Dict]:
        return self.table.telemetry()

    def class_totals(self) -> Dict[int, OpCounts]:
        return self.table.class_totals()

    def hot_keys(self, k: int = 10) -> List[List]:
        return self.table.hot_keys(k)

    def inflation_log(self) -> List[List]:
        return self.table.inflation_log()

    def overload_report(self) -> Optional[Dict]:
        """The overload layer's breaker/budget/hedge telemetry, or ``None``
        when the service was built without an :class:`OverloadPolicy`."""
        ctl = self.table.overload
        return None if ctl is None else ctl.report()

    # ------------------------------------------------------------ named locks
    def lock(self, name: str, home_host: int = 0) -> ALock:
        """A singleton control-plane lock pinned to an explicit home host."""
        with self._guard:
            lk = self._locks.get(name)
            if lk is None:
                lk = ALock(
                    self.mem, home_host, self._init_budget, name=f"svc.{name}"
                )
                self._locks[name] = lk
            assert lk.home_node == home_host, f"lock {name} homed elsewhere"
            return lk

    # ------------------------------------------------------------- election
    def elect(self, name: str, p: Process, epoch: int, home_host: int = 0) -> bool:
        """First-past-the-post election for ``epoch`` (e.g. checkpoint writer).

        Exactly one caller per epoch returns True.  The claim register lives on
        ``home_host``; the ALock around it gives each class its cost-optimal
        path per the paper.
        """
        lk = self.lock(name, home_host)
        key = f"svc.{name}.claim"
        with self._guard:
            reg = self._claims.get(key)
            if reg is None:
                reg = self.mem.alloc(home_host, key, -1)
                self._claims[key] = reg
        with lk.guard(p):
            cur = self.mem.auto_read(p, reg)
            if cur < epoch:
                self.mem.auto_write(p, reg, epoch)
                return True
            return False


class Barrier:
    """Sense-reversing barrier whose count register is guarded by an ALock.

    Used for elastic-membership epochs: all surviving hosts must arrive before
    the job re-meshes.  The count update runs in an ALock critical section
    (read-modify-write of a shared record under operation asymmetry — the
    exact situation where a naive mixed CAS would be unsound, Table 1).
    """

    def __init__(self, svc: CoordinationService, name: str, parties: int, home_host: int = 0):
        self.svc = svc
        self.parties = parties
        self.lock = svc.lock(f"{name}.bar", home_host)
        self.count = svc.mem.alloc(home_host, f"{name}.count", 0)
        self.generation = svc.mem.alloc(home_host, f"{name}.gen", 0)

    def wait(self, p: Process, timeout: float = 30.0) -> int:
        mem = self.svc.mem
        with self.lock.guard(p):
            gen = mem.auto_read(p, self.generation)
            n = mem.auto_read(p, self.count) + 1
            if n == self.parties:
                mem.auto_write(p, self.count, 0)
                mem.auto_write(p, self.generation, gen + 1)
                return gen
            mem.auto_write(p, self.count, n)
        # The deadline runs on the *table's* clock, not a hardcoded
        # time.monotonic: when the service was built with an injected clock
        # (tests' FakeClock, the sim engine's virtual clock), mixing time
        # bases would make the timeout fire never — or immediately.
        clock = self.svc.table.clock
        deadline = clock() + timeout
        while mem.auto_read(p, self.generation) == gen:
            if clock() > deadline:
                raise TimeoutError(f"barrier timeout (gen {gen}, {n}/{self.parties})")
            mem.yield_point()
        return gen
