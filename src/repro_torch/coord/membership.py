"""Lease-based cluster membership: heartbeats in the lock table itself.

Failure detection needs no new machinery when the cluster already runs a
lease service — a host's liveness *is* a lease.  Every host holds an
exclusive lease on its own **member key**, chosen (by salted search, the
same trick the benchmarks use) to hash to a shard homed on that host, so
the heartbeat renewal rides the paper's asymmetric fast path: **0 RDMA
ops** for the owner (local CAS on its own word), and any observer can read
the word with **1 remote read** — or :meth:`~repro_torch.core.memory.
AsymmetricMemory.probe`, which returns :data:`~repro_torch.core.memory.TIMEOUT`
instead of blocking when the fabric has eaten the host.

Detection is *sliding-window suspicion*, the same two-bucket estimator
shape as :class:`~repro_torch.coord.inflation.ContentionEstimator`: each monitor
sweep probes every member word and notes a **miss** (expired word, or
probe timeout) or a **beat** (live word) into per-host buckets.  The
windowed miss rate drives a three-state verdict with hysteresis:

    ALIVE --[windowed misses ≥ suspect_misses]--> SUSPECT
    SUSPECT --[dead_misses CONSECUTIVE misses AND missing ≥ ttl]--> DEAD
    SUSPECT/DEAD --[recover_beats consecutive beats]--> ALIVE

(The windowed rate drives suspicion; the DEAD escalation is a streak —
a monitor whose sweep cycle stretches under probe timeouts must not have
its evidence decay out of the window faster than it accumulates.)

Successor choice is deterministic rank order: the successor of host *h* is
the next non-DEAD host after *h* (mod ``num_hosts``), so every observer
that agrees on the verdict vector agrees on who takes over — no election
round, no extra RDMA.

**Partition guard** (the rule that keeps a minority island from serving
stale grants): a monitor sweep that observes a live *majority* of member
words at time *t* attests the local host may serve until ``t +
guard_ttl``.  Because ``guard_ttl`` is strictly less than the time it
takes the majority side to declare a host DEAD (``ttl`` plus the suspicion
window), a partitioned minority's attestation lapses — and it degrades to
read-only lease validation — **before** any majority-side successor can
win a takeover.  That ordering is the safety argument (the classic
lease-based fencing discipline); ``docs/recovery.md`` has the proof
sketch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generator, List, Optional, Tuple

from ..core.memory import TIMEOUT, AsymmetricMemory, Process
from .ledger import LeaseLedger, RecoverableClient
from .table import ShardedLockTable, stable_key_hash

__all__ = [
    "ALIVE",
    "DEAD",
    "SUSPECT",
    "HostMembership",
    "SuspicionEstimator",
    "SuspicionPolicy",
    "member_key_for",
]

# Verdicts, ordered by severity.
ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


def member_key_for(table: ShardedLockTable, host: int,
                   num_hosts: int) -> str:
    """The member key for ``host``: a salted key that hashes to a shard
    homed on ``host`` itself, so the owner's heartbeat renewal is the
    0-RDMA local fast path.  Deterministic (first salt that lands)."""
    for salt in range(1 << 16):
        key = f"member/{host}/{salt}"
        s = stable_key_hash(key) % table.num_shards
        if s % num_hosts == host:
            return key
    raise RuntimeError(f"no member key found for host {host}")  # pragma: no cover


@dataclass
class SuspicionPolicy:
    """Tunables for the suspicion estimator and the partition guard.

    ``ttl`` is the member-lease TTL (seconds of virtual time); everything
    else is derived from it by default so a single knob scales the whole
    detector.  ``guard_ttl`` must undercut the detection time — the
    constructor enforces the fencing inequality."""

    ttl: float = 5e-3
    #: Heartbeat renew period; must leave slack under ``ttl``.
    beat_every: float = 0.0
    #: Monitor sweep period.
    sweep_every: float = 0.0
    #: Sliding-window width for the two-bucket miss estimator.
    window: float = 0.0
    #: Windowed misses at which a host becomes SUSPECT.
    suspect_misses: float = 2.0
    #: CONSECUTIVE misses at which SUSPECT escalates to DEAD (the host
    #: must also have been missing for at least ``ttl``).
    dead_misses: float = 4.0
    #: Consecutive live beats that clear SUSPECT/DEAD back to ALIVE.
    recover_beats: int = 3
    #: How long one majority attestation permits serving.
    guard_ttl: float = 0.0

    def __post_init__(self) -> None:
        if self.ttl <= 0:
            raise ValueError("ttl must be positive")
        if not self.beat_every:
            self.beat_every = self.ttl / 4.0
        if not self.sweep_every:
            self.sweep_every = self.ttl / 4.0
        if not self.window:
            self.window = 2.0 * self.ttl
        if not self.guard_ttl:
            self.guard_ttl = self.ttl
        if self.beat_every >= self.ttl:
            raise ValueError("beat_every must undercut ttl")
        if self.sweep_every > self.ttl:
            raise ValueError("sweep_every must not exceed ttl")
        if self.suspect_misses <= 0 or self.dead_misses < self.suspect_misses:
            raise ValueError("need 0 < suspect_misses <= dead_misses")
        if self.recover_beats < 1:
            raise ValueError("recover_beats must be >= 1")
        # The fencing inequality: a minority's attestation must lapse
        # before the majority side can possibly declare it DEAD.  A DEAD
        # verdict needs the host missing for >= ttl measured from its
        # FIRST missed probe (strictly after the cut began), so any
        # guard_ttl <= ttl lapses the island's attestation first.
        if self.guard_ttl > self.ttl:
            raise ValueError(
                f"guard_ttl ({self.guard_ttl:g}) must not exceed ttl "
                f"({self.ttl:g}) — the attestation must lapse before any "
                f"observer can reach a DEAD verdict")


class _HostHeat:
    """Two-bucket sliding-window miss counter for one monitored host —
    the same shape as ``ContentionEstimator._KeyHeat``, with a beat
    streak for hysteresis bolted on."""

    __slots__ = ("bucket", "count", "prev", "beats", "streak", "verdict",
                 "expired_since", "died_at")

    def __init__(self) -> None:
        self.bucket = -1        # window index of `count`
        self.count = 0.0        # misses in the current window
        self.prev = 0.0         # misses in the previous window
        self.beats = 0          # consecutive live beats
        self.streak = 0         # consecutive misses
        self.verdict = ALIVE
        self.expired_since: Optional[float] = None
        self.died_at: Optional[float] = None


class SuspicionEstimator:
    """Windowed miss-rate failure detector with hysteresis.

    Feed it one observation per monitored host per sweep — :meth:`beat`
    for a live word, :meth:`miss` for an expired word or probe timeout —
    and read the verdict back.  Misses age out on the two-bucket window
    (current bucket plus a linearly-decayed share of the previous one), so
    a burst of losses long past does not keep a host SUSPECT forever."""

    def __init__(self, policy: Optional[SuspicionPolicy] = None) -> None:
        self.policy = policy or SuspicionPolicy()
        self._heat: Dict[int, _HostHeat] = {}
        #: Verdict transitions: (t, host, old, new), for the event log.
        self.transitions: List[Tuple[float, int, str, str]] = []

    # ---------------------------------------------------------- internals
    def _entry(self, host: int) -> _HostHeat:
        h = self._heat.get(host)
        if h is None:
            h = self._heat[host] = _HostHeat()
        return h

    @staticmethod
    def _shift(h: _HostHeat, b: int) -> None:
        if b != h.bucket:
            h.prev = h.count if b == h.bucket + 1 else 0.0
            h.count = 0.0
            h.bucket = b

    def _rate(self, h: _HostHeat, now: float) -> float:
        w = self.policy.window
        b = int(now / w)
        self._shift(h, b)
        frac = now / w - b
        return h.count + h.prev * (1.0 - frac)

    def _set(self, h: _HostHeat, host: int, verdict: str,
             now: float) -> None:
        if verdict != h.verdict:
            self.transitions.append((round(now, 9), host, h.verdict, verdict))
            h.verdict = verdict

    # -------------------------------------------------------- observation
    def beat(self, host: int, now: float) -> str:
        """A sweep saw a live, unexpired member word for ``host``."""
        h = self._entry(host)
        self._shift(h, int(now / self.policy.window))
        h.expired_since = None
        h.streak = 0
        h.beats += 1
        if h.verdict != ALIVE and h.beats >= self.policy.recover_beats:
            h.died_at = None
            self._set(h, host, ALIVE, now)
        return h.verdict

    def miss(self, host: int, now: float, expired: bool) -> str:
        """A sweep saw an expired word (``expired=True``) or the probe
        timed out entirely (``expired=False`` — the fabric ate it).

        Either flavour starts the DEAD-eligibility clock: a dead host's
        member word is *unreachable*, not observably expired, so the
        streak start (``expired_since``) marks the first miss of the
        current uninterrupted run — after ``ttl`` of continuous missing
        the member lease has lapsed whichever flavour we saw.  (A host
        that is alive behind a cut keeps renewing locally; the
        successor's :meth:`HostMembership.confirm_dead` re-probe after
        the heal is what catches that race.)"""
        h = self._entry(host)
        h.beats = 0
        h.streak += 1
        if h.expired_since is None:
            h.expired_since = now
        b = int(now / self.policy.window)
        self._shift(h, b)
        h.count += 1.0
        rate = h.count + h.prev * (1.0 - (now / self.policy.window - b))
        p = self.policy
        if h.verdict == ALIVE and rate >= p.suspect_misses:
            self._set(h, host, SUSPECT, now)
        # DEAD is a streak, not a windowed rate: under probe timeouts the
        # sweep cycle stretches, and windowed evidence would decay as fast
        # as it accrues.  The duration term anchors the fencing proof —
        # it is measured from the first miss, strictly after any cut.
        if (h.verdict == SUSPECT and h.streak >= p.dead_misses
                and now - h.expired_since >= p.ttl):
            h.died_at = now
            self._set(h, host, DEAD, now)
        return h.verdict

    def suspect(self, host: int, now: float) -> str:
        """Out-of-band SUSPECT evidence — e.g. an open circuit breaker at
        the overload layer, meaning the host is slow or unreachable *from
        here*.  Marks an ALIVE host SUSPECT and nothing more: it feeds
        neither the miss streak nor the DEAD-eligibility clock, so breaker
        evidence can never escalate to DEAD (only missed heartbeats may
        kill — an overloaded-but-alive host must not lose its shards to a
        takeover it would immediately contest)."""
        h = self._entry(host)
        if h.verdict == ALIVE:
            h.beats = 0
            self._set(h, host, SUSPECT, now)
        return h.verdict

    # ------------------------------------------------------------- verdict
    def verdict(self, host: int) -> str:
        h = self._heat.get(host)
        return h.verdict if h is not None else ALIVE

    def rate(self, host: int, now: float) -> float:
        h = self._heat.get(host)
        return self._rate(h, now) if h is not None else 0.0

    def died_at(self, host: int) -> Optional[float]:
        h = self._heat.get(host)
        return h.died_at if h is not None else None


class HostMembership:
    """One host's view of the cluster: its own heartbeat lease, its
    monitor's suspicion estimator, and the partition-guard attestation.

    Built per host by :meth:`~repro_torch.coord.service.CoordinationService.
    membership`.  The heartbeat and monitor loops are sim-task generators
    (:meth:`heartbeat_task`, :meth:`monitor_task`) so workloads spawn them
    alongside client fleets; threaded callers can drive :meth:`beat_once`
    and :meth:`sweep_once` directly."""

    def __init__(self, table: ShardedLockTable, mem: AsymmetricMemory,
                 host: int, num_hosts: int,
                 policy: Optional[SuspicionPolicy] = None,
                 ledger: Optional[LeaseLedger] = None) -> None:
        self.table = table
        self.mem = mem
        self.host = int(host)
        self.num_hosts = int(num_hosts)
        self.policy = policy or SuspicionPolicy()
        self.estimator = SuspicionEstimator(self.policy)
        #: member key per host, identical on every observer (pure hash).
        self.member_keys: Tuple[str, ...] = tuple(
            member_key_for(table, h, num_hosts) for h in range(num_hosts))
        self.p: Process = mem.spawn(self.host)
        self.ledger = ledger if ledger is not None else LeaseLedger(
            f"member.h{self.host}")
        self.client = RecoverableClient(table, self.p, self.ledger)
        self._lease = None
        #: latest majority attestation time (None = never attested).
        self.attested_at: Optional[float] = None
        #: sweeps that saw a live majority / that did not.
        self.attestations = 0
        self.quorum_losses = 0
        #: serve-permission refusals observed via :meth:`can_serve`.
        self.guard_blocks = 0
        self.stopped = False

    # ---------------------------------------------------------- heartbeat
    def beat_once(self) -> bool:
        """Acquire or renew this host's member lease.  Returns whether the
        lease is held after the call.  Renewal is the owner-local fast
        path: the member key's shard is homed here by construction."""
        key = self.member_keys[self.host]
        ttl = self.policy.ttl
        if self._lease is not None:
            renewed = self.client.renew(self._lease, ttl)
            if renewed is not None:
                self._lease = renewed
                return True
            self._lease = None
        lease = self.client.try_acquire(key, ttl)
        if lease is not None:
            self._lease = lease
            return True
        return False

    def heartbeat_task(self) -> Generator:
        """Sim task: renew the member lease every ``beat_every``."""
        while not self.stopped:
            self.beat_once()
            yield self.policy.beat_every

    # ------------------------------------------------------------ monitor
    def sweep_once(self) -> Dict[int, str]:
        """Probe every member word once and feed the estimator; refresh
        the majority attestation if enough words were live.  Returns the
        verdict vector."""
        now = self.table.clock()
        live = 0
        for h in range(self.num_hosts):
            if h == self.host:
                # Our own beat is ground truth; no self-probe.
                self.estimator.beat(h, now)
                live += 1
                continue
            key = self.member_keys[h]
            shard = self.table.shards[self.table.shard_of(key)]
            st = self.table._key_state(shard, key)
            word = self.mem.probe(self.p, st.expires)
            if word is TIMEOUT:
                self.estimator.miss(h, now, expired=False)
                continue
            _tok, _readers, expires_at = word
            if expires_at > now:
                self.estimator.beat(h, now)
                live += 1
            else:
                self.estimator.miss(h, now, expired=True)
        # Overload composition: an open breaker (the table's overload layer
        # refusing a host it found slow/timing out from here) is SUSPECT
        # evidence — and only that.  It never feeds the miss streak or the
        # DEAD clock, and quorum attestation above runs on probe ground
        # truth alone (a congested majority must still attest).
        ctl = self.table.overload
        if ctl is not None:
            for h in ctl.open_hosts():
                if h != self.host and 0 <= h < self.num_hosts:
                    self.estimator.suspect(h, now)
        if 2 * live > self.num_hosts:
            self.attested_at = now
            self.attestations += 1
        else:
            self.quorum_losses += 1
        return {h: self.estimator.verdict(h) for h in range(self.num_hosts)}

    def monitor_task(self) -> Generator:
        """Sim task: sweep every ``sweep_every``."""
        while not self.stopped:
            self.sweep_once()
            yield self.policy.sweep_every

    # ----------------------------------------------------- partition guard
    def can_serve(self) -> bool:
        """Forward-valid quorum attestation: True iff a sweep observed a
        live majority within the last ``guard_ttl``.  A minority island's
        attestation lapses before the majority can declare it dead, so
        refusing to serve here is exactly the fencing rule."""
        now = self.table.clock()
        ok = (self.attested_at is not None
              and now - self.attested_at < self.policy.guard_ttl)
        if not ok:
            self.guard_blocks += 1
        return ok

    # ----------------------------------------------------------- successor
    def live_hosts(self) -> List[int]:
        return [h for h in range(self.num_hosts)
                if self.estimator.verdict(h) != DEAD]

    def successor(self, dead_host: int) -> Optional[int]:
        """Deterministic takeover rank: the first non-DEAD host after
        ``dead_host`` in ring order.  Every observer with the same verdict
        vector picks the same successor."""
        for step in range(1, self.num_hosts):
            h = (dead_host + step) % self.num_hosts
            if self.estimator.verdict(h) != DEAD:
                return h
        return None

    def is_successor(self, dead_host: int) -> bool:
        return self.successor(dead_host) == self.host

    # ------------------------------------------------------------ takeover
    def confirm_dead(self, host: int) -> bool:
        """Post-verdict re-probe of the dead host's member word, run by
        the successor *after* winning the epoch CAS: a live unexpired word
        means the host came back (or was never gone — we were on the wrong
        side of a heal) and the takeover must abort.  TIMEOUT or an
        expired word confirms."""
        key = self.member_keys[host]
        shard = self.table.shards[self.table.shard_of(key)]
        st = self.table._key_state(shard, key)
        word = self.mem.probe(self.p, st.expires)
        if word is TIMEOUT:
            return True
        _tok, _readers, expires_at = word
        return expires_at <= self.table.clock()

    def stop(self) -> None:
        self.stopped = True
