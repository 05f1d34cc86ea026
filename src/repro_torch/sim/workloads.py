"""Sim workloads: cooperative lock-table clients at 100× threaded scale.

Each client is a generator task on a :class:`~repro_torch.sim.SimEngine`, driving a
:class:`~repro_torch.coord.ShardedLockTable` built over a
:class:`~repro_torch.sim.SimFabricMemory`.  Everything — key choice, backoff,
think time, the fabric's latency charges, the scheduler's tie-breaks — is
derived from the run's seed, so a config produces **byte-identical** results
every time: exact per-class (and per-mode) RDMA/doorbell counts, exact
grant/reject/expiry tallies, and a virtual-time throughput with zero
run-to-run dispersion.

Clients use the table's **non-blocking** operations (``try_acquire`` /
``renew`` / ``release``) and express waiting as generator yields, which is
the contract the engine's atomic-step model requires (see
``repro_torch.sim.engine``); contention shows up as rejects + seeded exponential
backoff rather than thread preemption.

Workloads (mirroring, then extending, the threaded bench):

* ``home``     — each client draws only keys homed on its own host: the
  placement-aware layout.  Every operation is local-class; the run asserts
  the whole REMOTE class stays at zero ops.
* ``uniform``  — placement-oblivious uniform draws over the global keyspace.
* ``zipfian``  — Zipf(s)-skewed draws over the global keyspace: a handful of
  hot keys absorb most traffic.  Only feasible at simulated scale — at
  64×16 clients the hot keys see the contention regime the RDMA
  lock-service literature actually studies.
* ``failover`` — a hot key set with short TTLs where ``crash_prob`` of
  holders silently die mid-lease and later wake as zombies: leases expire,
  hundreds of contenders storm the freed keys, and the woken zombies try to
  renew with stale leases.  The run asserts every zombie renewal is fenced
  off and grant tokens never regress.
* ``read_heavy`` — the mode-aware workload: a ``1 - write_frac`` fraction of
  transactions take SHARED leases (reader cohorts on the packed S/X word),
  the rest take EXCLUSIVE.  ``home_frac`` of each client's draws come from
  its own host's keys (zipfian within them — home readers are the paper's
  zero-RDMA class), the rest from a global zipfian (remote shared traffic,
  priced at one rCAS per join).  ``shared_reads=False`` degrades every
  reader to EXCLUSIVE — the before/after baseline for the read:write sweep.
* ``reader_flood`` — the writer-progress scenario: every client but one
  hammers ONE key with shared leases; the lone writer periodically needs an
  exclusive grant.  The run records each writer wait in virtual time and
  asserts the drain protocol bounds it (a saturating reader flood cannot
  starve a queued writer past ~a TTL).
* ``crash_restart`` — the recovery workload: ledger-writing clients
  (:class:`~repro_torch.coord.RecoverableClient`) run a seeded mix of single-key,
  batch, and shared/upgrade transactions over a hot key set while a
  **crash reaper** kills every client task on a seeded schedule of hosts
  (:meth:`~repro_torch.sim.SimEngine.kill` delivers :class:`ClientCrash` at the
  victims' next dispatch).  Each victim restarts after ``restart_delay``
  and — with ``reclaim=True`` — replays its ledger and reclaims its
  still-valid leases via the fencing-checked CAS; with ``reclaim=False``
  it rejoins amnesiac and the run measures the full-TTL wedge instead
  (the before/after pair the recovery benchmark reports).  Per-lease
  recovery latencies and per-restart recovery events are recorded in
  virtual time; fencing-token monotonicity is asserted throughout.
* ``home_death`` — the self-healing workload: every host runs a
  :class:`~repro_torch.coord.HostMembership` heartbeat + monitor pair alongside
  its ledgered clients, and at a seeded instant one host **dies for good**
  — its memory drops off the fabric (``FabricFaults.fail_host``) and every
  one of its tasks is killed.  Surviving clients burn op-timeout retry
  budgets against the corpse (:class:`RemoteTimeout`), the suspicion
  estimators walk it ALIVE→SUSPECT→DEAD, and the rank-order successor runs
  the epoch-fenced takeover of every shard homed there.  The run then
  re-acquires every key of the dead home from the successor and asserts
  all of them re-homed with monotonic fencing tokens, and that the
  crash→takeover latency p99 stays under 5× the membership TTL.
* ``partition`` — the split-brain workload: a minority island of hosts is
  cut from the rest for a scheduled window.  Minority clients draw only
  majority-homed keys, so every acquire must cross the cut; the partition
  guard (quorum attestation with ``guard_ttl`` undercutting the detection
  floor) degrades the island before the majority can declare it dead.  The
  run asserts **zero grants landed on the minority side inside the
  window**, and that the guard actually blocked takeovers
  (``takeover_refusals``) rather than the window just being quiet.
* ``overload_storm`` — the overload workload: an **open-loop** paced
  arrival stream (mean interarrival ``STORM_INTERARRIVAL / offered_load``
  per client) over a zipfian keyspace, against a fabric whose per-host
  congestion model (``congest_capacity`` postings per window) makes excess
  load *cost latency*.  Every transaction carries an absolute deadline
  (``deadline_budget`` past its arrival) through the table's **blocking**
  ``acquire``: backoff sleeps are clamped to the remaining budget, a passed
  deadline raises the typed :class:`~repro_torch.core.DeadlineExceeded`, and —
  with ``shedding=True`` — a deadline-infeasible retry is **shed**
  (:class:`~repro_torch.core.Overloaded`) before it burns another posting.
  Three of four clients are EXCLUSIVE writers at priority 0 (sheddable);
  the fourth is a SHARED reader at priority 1 — the brownout contract the
  run records: reader goodput keeps flowing while writer load sheds.
  **Goodput** is the grants that landed inside their deadline; the bench
  sweeps ``offered_load`` 1x→10x and gates goodput retention, the non-shed
  acquire p99, and the shedding-ON vs shedding-OFF collapse.
"""

from __future__ import annotations

import bisect
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.coord import (DEAD, AsyncClient, ClientCrash, FaultInjector,
                         HostMembership, InflationPolicy, LedgerStore,
                         OverloadPolicy, RecoverableClient, ShardedLockTable,
                         SuspicionPolicy)
from repro_torch.coord.table import EXCLUSIVE, LOCAL, REMOTE, SHARED, LeaseMode
from ..core import DeadlineExceeded, Overloaded, RemoteTimeout

from .engine import SimEngine
from .fabric import FabricFaults, FabricLatency, SimFabricMemory

__all__ = ["SIM_WORKLOADS", "KEYS_PER_HOST", "STORM_INTERARRIVAL",
           "SimResult", "jain", "keys_by_home", "run_lock_table_sim"]

SIM_WORKLOADS = ("home", "uniform", "zipfian", "failover", "read_heavy",
                 "reader_flood", "crash_restart", "home_death", "partition",
                 "overload_storm", "pipelined_read")

KEYS_PER_HOST = 8   # keyspace density; shared with the threaded bench
# overload_storm base (1x) mean interarrival.  A remote EXCLUSIVE
# transaction costs ~134us of virtual time end-to-end (4 acquire doorbells
# + release), so 450us paces 1x at ~30% per-client utilization — loaded
# enough to measure, far enough from saturation that queueing is benign.
STORM_INTERARRIVAL = 450e-6
HOLD = 10e-6        # virtual seconds a lease is held
THINK = 5e-6        # virtual think time between transactions
BACKOFF = 20e-6     # initial reject backoff (doubles, capped)
BACKOFF_CAP = 2e-3


def _pct(xs: List[float], q: float) -> float:
    """The q-quantile (nearest-rank) of ``xs``; 0.0 for an empty list."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def jain(xs: List[int]) -> float:
    """Jain fairness index over per-client op counts (threaded + sim)."""
    xs = [x for x in xs if x >= 0]
    total = sum(xs)
    if total == 0:
        return 0.0
    return total * total / (len(xs) * sum(x * x for x in xs))


class _RunState:
    """Shared counters + safety invariants (steps are atomic: no locking).

    Token monotonicity is checked **per mode**: an EXCLUSIVE grant must
    carry a token strictly larger than every token seen for the key (the
    CS allocator never reuses one), while a SHARED grant carries its reader
    generation's token — the last CS-allocated one — so equality with the
    running maximum is legal but a *smaller* token is a regression.
    """

    __slots__ = ("per_client", "total", "target", "last_token",
                 "token_regressions", "zombie_renews", "reads",
                 "grants_by_mode", "writer_waits",
                 "crashes", "reclaims", "recovery_latencies",
                 "recovery_events", "hot_latencies", "hot_rcas",
                 "remote_timeouts", "crash_times", "detect_latencies",
                 "takeover_latencies", "failover_events",
                 "minority_grants", "minority", "window",
                 "offered", "goodput", "goodput_shared", "late_grants",
                 "shed_ops", "deadline_misses", "storm_latencies")

    def __init__(self, nclients: int, target: int):
        self.per_client = [0] * nclients
        self.total = 0
        self.target = target
        self.last_token: Dict[str, int] = {}
        self.token_regressions = 0
        self.zombie_renews = 0
        # Lease-free optimistic reads completed.  They count
        # toward the ops target and fairness like grants do — each is one
        # client-visible operation — but carry no lease, so they must not
        # feed the per-key token-monotonicity check.
        self.reads = 0
        self.grants_by_mode = {SHARED: 0, EXCLUSIVE: 0}
        self.writer_waits: List[float] = []
        # Crash-recovery accounting (crash_restart workload).
        self.crashes = 0
        self.reclaims = 0
        self.recovery_latencies: List[float] = []
        # One entry per completed restart: [client idx, leases recovered].
        self.recovery_events: List[List[int]] = []
        # Failover accounting (home_death / partition workloads).
        self.remote_timeouts = 0            # client-visible retry exhaustions
        self.crash_times: Dict[int, float] = {}   # host -> scheduled death
        self.detect_latencies: List[float] = []   # death -> DEAD verdict
        self.takeover_latencies: List[float] = []  # death -> shard re-homed
        # One entry per committed takeover:
        # [t, dead host, shard, new epoch, leases intact, leases reset].
        self.failover_events: List[List] = []
        self.minority_grants = 0            # in-window grants on the island
        self.minority: Optional[frozenset] = None
        self.window: Optional[tuple] = None  # the partition (start, end)
        # Tracked-hot-key probes (zipfian workload): per-grant acquire
        # latency in virtual time, and the rCAS each REMOTE client paid
        # from first attempt to grant — the quantity inflation bounds.
        self.hot_latencies: List[float] = []
        self.hot_rcas: List[int] = []
        # Overload accounting (overload_storm workload).  ``offered`` is
        # arrivals, ``goodput`` the grants that landed inside their
        # deadline; sheds / deadline misses are the *client-observed*
        # refusals (the table keeps its own per-shard tallies).
        self.offered = 0
        self.goodput = 0
        self.goodput_shared = 0
        self.late_grants = 0        # granted, but past the caller deadline
        self.shed_ops = 0
        self.deadline_misses = 0
        self.storm_latencies: List[float] = []  # every grant's acquire time

    def done(self) -> bool:
        return self.total >= self.target

    def granted(self, idx: int, lease) -> None:
        self.per_client[idx] += 1
        self.total += 1
        self.grants_by_mode[lease.mode] += 1
        prev = self.last_token.get(lease.key, 0)
        if lease.token < prev or (lease.mode == EXCLUSIVE
                                  and lease.token == prev):
            self.token_regressions += 1
        else:
            self.last_token[lease.key] = lease.token

    def read_done(self, idx: int) -> None:
        """One optimistic read completed (lease-free: no token to check)."""
        self.per_client[idx] += 1
        self.total += 1
        self.reads += 1

    def recovered(self, idx: int, latency: float) -> None:
        """One lease recovered after a restart (reclaimed, or re-acquired
        past the wedge in the amnesiac baseline) — NOT a grant: a reclaim
        keeps its token, so it must not feed the monotonicity check."""
        self.reclaims += 1
        self.recovery_latencies.append(latency)


# ------------------------------------------------------------- key pickers
def _zipf_picker(keys: List[str], s: float) -> Callable:
    """Zipf(s) over ``keys``: rank r drawn with weight 1/r^s (r = 1-based)."""
    cum, acc = [], 0.0
    for r in range(1, len(keys) + 1):
        acc += 1.0 / r ** s
        cum.append(acc)
    total = cum[-1]

    def pick(rng: random.Random) -> str:
        return keys[bisect.bisect_right(cum, rng.random() * total)]

    return pick


def keys_by_home(table: ShardedLockTable, num_hosts: int, per_host: int,
                 prefix: str = "home/",
                 strict: bool = True) -> Dict[int, List[str]]:
    """``per_host`` keys homed on each host, by stable-hash placement scan.

    Shared by the sim workloads and the threaded bench (one scanner, so the
    two modes cannot drift).  ``strict=True`` raises when a host owns no
    shard (the sim's home workload is meaningless then); ``strict=False``
    pads under-filled hosts with keys homed elsewhere — the threaded
    bench's shards<hosts baseline, where locality is impossible for them
    and that *is* the cost story being measured.
    """
    out: Dict[int, List[str]] = {h: [] for h in range(num_hosts)}
    pool: List[str] = []
    need = num_hosts * per_host
    for i in range(200 * need):
        if all(len(ks) >= per_host for ks in out.values()):
            break
        k = f"{prefix}{i}"
        pool.append(k)
        ks = out[table.home_of(k)]
        if len(ks) < per_host:
            ks.append(k)
    short = [h for h, ks in out.items() if len(ks) < per_host]
    if short and strict:
        raise ValueError(
            f"hosts {short} own no (or too few) shards — the home workload "
            f"needs num_shards >= num_hosts (got {table.num_shards} shards "
            f"for {num_hosts} hosts)"
        )
    for h in short:
        j = 0
        while len(out[h]) < per_host:
            out[h].append(pool[(h * per_host + j) % len(pool)])
            j += 1
    return out


# ------------------------------------------------------------ client tasks
def _acquire_release_client(table, p, rng, pick, st, idx, ttl):
    backoff = BACKOFF
    while not st.done():
        lease = table.try_acquire(p, pick(rng), ttl)
        if lease is None:
            yield backoff * (0.5 + rng.random())
            backoff = min(backoff * 2, BACKOFF_CAP)
            continue
        backoff = BACKOFF
        st.granted(idx, lease)
        yield HOLD
        table.release(p, lease)
        yield THINK


def _sticky_hot_client(table, p, rng, pick, st, idx, ttl, track):
    """The zipfian client: sticky key choice + tracked hot-key probes.

    The plain client re-picks a fresh key after every reject, which lets a
    loser walk away from the hottest key — diluting exactly the contention
    regime the zipfian workload exists to measure, and making per-key
    acquire latency unattributable.  Real callers want THE key they asked
    for, so this client retries the same key (seeded exponential backoff)
    until granted, and for keys in ``track`` records the virtual-time
    acquire latency (first attempt -> grant) and, for remote clients, the
    rCAS the grant cost — the two quantities the inflation gates bound.
    """
    clock = table.clock
    home = {k: table.home_of(k) for k in track}
    while not st.done():
        key = pick(rng)
        tracked = key in home
        remote = tracked and p.node != home[key]
        t0 = clock()
        rcas0 = p.counts.remote_cas
        backoff = BACKOFF
        lease = None
        while lease is None:
            lease = table.try_acquire(p, key, ttl)
            if lease is None:
                if st.done():
                    return
                if table.queued(p, key):
                    # Inflated mode: parked in the key's MCS queue, where a
                    # poll is ONE local read (the local spin).  Fine-grained
                    # constant cadence — exponential backoff here would gate
                    # every FIFO handoff on the head's (huge) poll period.
                    yield HOLD * (0.5 + rng.random())
                    backoff = BACKOFF
                else:
                    yield backoff * (0.5 + rng.random())
                    backoff = min(backoff * 2, BACKOFF_CAP)
        if tracked:
            st.hot_latencies.append(clock() - t0)
            if remote:
                st.hot_rcas.append(p.counts.remote_cas - rcas0)
        st.granted(idx, lease)
        yield HOLD
        table.release(p, lease)
        yield THINK


def _mode_mix_client(table, p, rng, pick, st, idx, ttl, write_frac,
                     shared_reads, hold):
    """The read_heavy client: a seeded S/X mix over the picked keys.

    ``hold`` is the lease-hold time — the work done under the lease (a scan
    for readers, a mutation for writers).  It is the quantity S/X sharing
    monetises: exclusive-only serialises every hot key's holds end-to-end,
    shared mode overlaps the read holds.
    """
    backoff = BACKOFF
    while not st.done():
        is_write = rng.random() < write_frac
        mode = EXCLUSIVE if (is_write or not shared_reads) else SHARED
        lease = table.try_acquire(p, pick(rng), ttl, mode=mode)
        if lease is None:
            yield backoff * (0.5 + rng.random())
            backoff = min(backoff * 2, BACKOFF_CAP)
            continue
        backoff = BACKOFF
        st.granted(idx, lease)
        yield hold
        table.release(p, lease)
        yield THINK


def _opt_mix_client(table, p, rng, pick, st, idx, ttl, write_frac, hold):
    """The read_heavy client on the optimistic read path.

    Same seeded R/W mix as :func:`_mode_mix_client`, but readers go
    lease-free through ``read_optimistic`` (0 RDMA at home, one doorbell
    remote, never blocking a writer) and writers publish the payload
    ``(token, key)`` their readers verify — a returned snapshot whose
    token or key disagrees is a torn/stale read and fails the run.
    """
    backoff = BACKOFF
    while not st.done():
        key = pick(rng)
        if rng.random() < write_frac:
            lease = table.try_acquire(p, key, ttl)
            if lease is None:
                yield backoff * (0.5 + rng.random())
                backoff = min(backoff * 2, BACKOFF_CAP)
                continue
            backoff = BACKOFF
            st.granted(idx, lease)
            table.publish(p, lease, (lease.token, key))
            yield hold
            table.release(p, lease)
        else:
            # poll=BACKOFF: the retry backoff must be on the same scale as
            # the writers' hold time, or a reader that catches a live
            # writer oversleeps the whole grant window.  None means a
            # live writer holds the key right now: back off HERE (the
            # client may yield; the table may not) and re-issue.
            got = table.read_optimistic(p, key, poll=BACKOFF)
            while got is None:
                yield backoff * (0.5 + rng.random())
                backoff = min(backoff * 2, BACKOFF_CAP)
                got = table.read_optimistic(p, key, poll=BACKOFF)
            backoff = BACKOFF
            val, tok = got
            if val is not None and (val[0] != tok or val[1] != key):
                raise AssertionError(
                    f"read_heavy/optimistic: torn or stale payload "
                    f"{val!r} (token {tok}) for key {key!r}")
            st.read_done(idx)
            yield hold  # the scan runs on the snapshot, outside any lease
        yield THINK


def _pipelined_read_client(table, pl, rng, st, idx, ttl, per_host, host,
                           num_hosts, writer, burst):
    """The pipelined_read client: bursty remote reads through an
    :class:`~repro_torch.coord.AsyncClient`.

    Readers aim each burst at ONE remote host — ``burst`` keys homed
    there enqueue as futures and flush as a single mixed posting, so the
    whole burst costs one doorbell (the aggregate doorbells-per-op < 1
    gate).  One client per host is the writer: it mutates its OWN host's
    keys (home class, zero RDMA) and publishes ``(token, key)`` so the
    readers' torn-read check has live writes to race against; its
    releases ride the pipeline too.
    """
    p = pl.p
    if writer:
        keys = per_host[host]
        backoff = BACKOFF
        while not st.done():
            key = rng.choice(keys)
            lease = table.try_acquire(p, key, ttl)
            if lease is None:
                yield backoff * (0.5 + rng.random())
                backoff = min(backoff * 2, BACKOFF_CAP)
                continue
            backoff = BACKOFF
            st.granted(idx, lease)
            table.publish(p, lease, (lease.token, key))
            yield HOLD
            pl.sync(pl.release(lease))
            yield THINK
        return
    others = [h for h in range(num_hosts) if h != host] or [host]
    while not st.done():
        target = rng.choice(others)
        keys = [rng.choice(per_host[target]) for _ in range(burst)]
        futs = [[k, pl.read_optimistic(k)] for k in keys]
        pl.flush()
        while futs:
            still = []
            for ent in futs:
                key, fut = ent
                if not fut.done():
                    still.append(ent)
                    continue
                got = fut.result()
                if got is None:
                    # A live writer held the key at flush time: re-issue
                    # the read; it rides the next flush posting.
                    ent[1] = pl.read_optimistic(key)
                    still.append(ent)
                    continue
                val, tok = got
                if val is not None and (val[0] != tok or val[1] != key):
                    raise AssertionError(
                        f"pipelined_read: torn or stale payload {val!r} "
                        f"(token {tok}) for key {key!r}")
                st.read_done(idx)
            futs = still
            if futs:
                # Unstable snapshots re-enqueued a retry (or a re-issue
                # is queued): give the writer a beat, then flush the
                # retry posting.
                yield BACKOFF * (0.5 + rng.random())
                pl.flush()
        yield THINK


def _flood_reader(table, p, rng, st, idx, key, ttl):
    """A reader hammering one key with shared joins, as fast as it can."""
    while not st.done():
        lease = table.try_acquire(p, key, ttl, mode=SHARED)
        if lease is None:
            yield BACKOFF * (0.5 + rng.random())
            continue
        st.granted(idx, lease)
        yield HOLD
        table.release(p, lease)
        yield THINK


def _flood_writer(table, p, rng, st, idx, key, ttl):
    """The queued writer: periodically needs EXCLUSIVE through the flood.

    Each wait is recorded in virtual time; the drain barrier (armed by the
    writer's first blocked critical section) must bound it near one TTL no
    matter how saturating the reader flood is.
    """
    clock = table.clock
    while not st.done():
        yield 20 * HOLD  # between writes the readers own the key
        t0 = clock()
        while True:
            lease = table.try_acquire(p, key, ttl, mode=EXCLUSIVE)
            if lease is not None:
                break
            if st.done():
                return
            yield (ttl / 8) * (0.5 + rng.random())
        st.writer_waits.append(clock() - t0)
        st.granted(idx, lease)
        yield HOLD
        table.release(p, lease)


def _storm_client(table, p, rng, pick, st, idx, ttl, budget, interarrival,
                  reader, shedding, run_until):
    """The overload_storm client: open-loop paced arrivals with deadlines.

    Unlike every closed-loop client above, this one does NOT wait for the
    previous transaction before generating the next arrival tick — offered
    load is set by ``interarrival``, not by service capacity, which is what
    makes overload *possible*.  Each transaction runs the table's blocking
    ``acquire`` with an absolute deadline ``budget`` past its arrival;
    writers at priority 0 are sheddable, readers ride at priority 1 in
    SHARED mode (the brownout half: reads keep flowing while writes shed).
    A shed (:class:`Overloaded`), a burned deadline
    (:class:`DeadlineExceeded`) or an exhausted fabric retry budget
    (:class:`RemoteTimeout`) each fail fast into a counter and the client
    simply waits for its next arrival — no retry amplification beyond what
    the acquire loop itself decided was feasible.
    """
    clock = table.clock
    # A contended word frees by expiry, and the acquire loop's backoff
    # DOUBLES from ``poll`` — a coarse poll overshoots the expiry instant
    # by whole multiples of the TTL.  ttl/16 keeps the whole doubling
    # ladder (p, 2p, 4p, ...) inside roughly one quantum.
    poll = ttl / 16
    hold = min(HOLD, ttl / 8)
    mode = SHARED if reader else EXCLUSIVE
    priority = 1 if (reader or not shedding) else 0
    next_at = clock() + interarrival * (0.5 + rng.random())
    while True:
        now = clock()
        if next_at > now:
            yield next_at - now
        t_sched = next_at
        next_at = t_sched + interarrival * (0.5 + rng.random())
        if t_sched >= run_until:
            return
        st.offered += 1
        deadline = t_sched + budget
        if shedding and clock() >= deadline:
            # Admission shed: the arrival expired in this client's own
            # backlog, so attempting it cannot possibly help — drop it for
            # free and catch up to arrivals that can still be served.  The
            # OFF control leg is exactly this line withheld: a doomed
            # arrival still burns a (congested) posting before its
            # DeadlineExceeded, which is how a backlog snowballs into the
            # goodput collapse the sweep measures.
            st.shed_ops += 1
            continue
        try:
            lease = table.acquire(p, pick(rng), ttl, poll=poll, mode=mode,
                                  deadline=deadline, priority=priority)
        except Overloaded:
            st.shed_ops += 1
            continue
        except RemoteTimeout:
            st.remote_timeouts += 1
            continue
        except DeadlineExceeded:
            st.deadline_misses += 1
            continue
        lat = clock() - t_sched
        st.storm_latencies.append(lat)
        st.granted(idx, lease)
        if lat <= budget:
            st.goodput += 1
            if reader:
                st.goodput_shared += 1
        else:
            # Granted, but only after the caller's deadline had already
            # passed (the last pre-deadline poll can land late by one
            # congested attempt) — useless to the caller, not goodput.
            st.late_grants += 1
        yield hold
        try:
            table.release(p, lease)
        except RemoteTimeout:
            pass


def _failover_client(table, p, rng, pick, st, idx, ttl, crash_prob):
    hold = min(HOLD, ttl / 8)
    backoff = ttl / 4
    while not st.done():
        lease = table.try_acquire(p, pick(rng), ttl)
        if lease is None:
            yield backoff * (0.5 + rng.random())
            backoff = min(backoff * 2, 8 * ttl)
            continue
        backoff = ttl / 4
        st.granted(idx, lease)
        if rng.random() < crash_prob:
            # Crash mid-lease: hold silently past expiry, then wake as a
            # zombie and try to renew the stale lease.  Fencing must reject
            # it — by then the expiry register is past-due (or re-granted
            # with a larger token), so the renewal can never stick.
            yield ttl * (1.5 + rng.random())
            if table.renew(p, lease) is not None:
                st.zombie_renews += 1
            yield ttl * rng.random()  # recovery pause before rejoining
            continue
        yield hold
        renewed = table.renew(p, lease)
        if renewed is not None:
            yield hold
            table.release(p, renewed)
        yield THINK


def _recoverable_client(mem, table, store, host, idx, rng, pick, st, ttl,
                        restart_delay, reclaim):
    """The crash_restart client: a ledger-writing mix of single-key, batch
    and shared/upgrade transactions, structured as a state machine whose
    every ``yield`` sits inside the ``try`` — a :class:`ClientCrash` can
    land at ANY parked yield (the reaper) or synchronously inside a table
    call (a FaultInjector crash point) and is always funneled into the
    crashed state.  Restart either replays-and-reclaims (``reclaim=True``)
    or rejoins amnesiac and measures the wedge (``reclaim=False``)."""
    clock = table.clock
    p = mem.spawn(host)
    rc = RecoverableClient(table, p, store.ledger(f"client/{idx}"))
    hold = min(HOLD, ttl / 8)
    backoff = ttl / 4
    state = "run"   # "run" | "down" | ("wedge", t0, keys)
    while True:
        try:
            if st.done():
                return
            if state == "down":
                yield restart_delay  # the host is dark
                p = mem.spawn(host)  # a fresh incarnation (new pid)
                if reclaim:
                    t0 = clock()
                    got = rc.restart(p)
                    now = clock()
                    for lease in got:
                        st.recovered(idx, now - t0)
                        rc.release(lease)  # resume with a clean slate
                    st.recovery_events.append([idx, len(got)])
                    state = "run"
                else:
                    # Amnesiac baseline: the restarted client must wait
                    # out its dead incarnation's leases like a stranger.
                    # The ledger is used only to MEASURE (which keys the
                    # corpse still holds), never to recover.
                    t0 = clock()
                    view = rc.ledger.replay()
                    keys = sorted(
                        k for k, r in view.live.items()
                        if r.mode == int(EXCLUSIVE) and r.expires_at > t0)
                    rc.adopt_process(p)
                    if keys:
                        state = ("wedge", t0, keys)
                    else:
                        st.recovery_events.append([idx, 0])
                        state = "run"
                continue
            if isinstance(state, tuple):
                _tag, t0, keys = state
                lease = table.try_acquire(p, keys[0], ttl)
                if lease is not None:
                    st.recovered(idx, clock() - t0)
                    table.release(p, lease)
                    keys.pop(0)
                    if not keys:
                        st.recovery_events.append([idx, 0])
                        state = "run"
                else:
                    yield (ttl / 16) * (0.5 + rng.random())
                continue
            # ----- normal operation: a mix that exercises every window
            r = rng.random()
            if r < 0.15:  # multi-key batch (mid-batch crash window)
                keys = sorted({pick(rng) for _ in range(3)})
                try:
                    # The timeout must stay well inside the TTL: a batch
                    # that polls past it returns leases already aging out,
                    # and nothing valid would be left to crash-recover.
                    leases = rc.acquire_batch(keys, ttl, timeout=ttl / 2)
                except TimeoutError:
                    yield backoff * (0.5 + rng.random())
                    continue
                for lease in leases:
                    st.granted(idx, lease)
                yield hold
                for lease in leases:
                    rc.release(lease)
                yield THINK
            elif r < 0.40:  # shared join, sometimes upgraded
                lease = rc.try_acquire(pick(rng), ttl, mode=SHARED)
                if lease is None:
                    yield backoff * (0.5 + rng.random())
                    continue
                st.granted(idx, lease)
                yield hold
                if rng.random() < 0.25:
                    up = rc.upgrade(lease)
                    if up is not None:
                        st.granted(idx, up)
                        lease = up
                        yield hold
                rc.release(lease)
                yield THINK
            else:  # single exclusive with a renewal (the failover shape)
                lease = rc.try_acquire(pick(rng), ttl)
                if lease is None:
                    yield backoff * (0.5 + rng.random())
                    continue
                st.granted(idx, lease)
                yield hold
                renewed = rc.renew(lease)
                if renewed is not None:
                    yield hold
                    rc.release(renewed)
                yield THINK
        except ClientCrash:
            st.crashes += 1
            state = "down"


def _crash_reaper(engine, schedule, tasks_by_host):
    """Kills every client task of each scheduled host at its crash time.
    The schedule is seeded data, so two same-seed runs kill the same tasks
    at the same instants — the determinism the CI crash gate diffs."""
    for t, host in schedule:
        dt = t - engine.clock.now
        if dt > 0:
            yield dt
        for task in tasks_by_host[host]:
            engine.kill(task, ClientCrash("host.crash", pid=host))


def _ha_client(mem, table, store, host, idx, rng, pick, st, ttl,
               member=None, run_until=0.0):
    """The failover-aware ledgered client (home_death / partition).

    Every table call sits inside the ``try``: a :class:`RemoteTimeout`
    (the key's home is unreachable and the op burned its retry budget)
    backs off and retries — after the takeover the key resolves to its
    new home and the same loop just works.  With a ``member`` attached
    the client consults the partition guard first and stops *acquiring*
    while its island has no quorum attestation (existing leases could
    still be validated; nothing new is granted).  ``run_until`` keeps
    the client generating traffic past the ops target, so a partition
    window is never quietly empty."""
    clock = table.clock
    p = mem.spawn(host)
    rc = RecoverableClient(table, p, store.ledger(f"client/{idx}"))
    hold = min(HOLD, ttl / 8)
    backoff = ttl / 4
    while not st.done() or clock() < run_until:
        try:
            if member is not None and not member.can_serve():
                yield member.policy.guard_ttl / 4
                continue
            t_att = clock()
            lease = rc.try_acquire(pick(rng), ttl)
            if lease is None:
                yield backoff * (0.5 + rng.random())
                backoff = min(backoff * 2, 8 * ttl)
                continue
            backoff = ttl / 4
            st.granted(idx, lease)
            # An in-window grant is one whose ATTEMPT started inside the
            # cut: an acquire decided entirely pre-cut may still have its
            # completion timestamp drift past the boundary on latency
            # charges, and that is a pre-cut grant, not a violation.
            if (st.window is not None and st.minority is not None
                    and host in st.minority
                    and st.window[0] <= t_att and clock() < st.window[1]):
                st.minority_grants += 1
            yield hold
            rc.release(lease)
            yield THINK
        except RemoteTimeout:
            st.remote_timeouts += 1
            yield backoff * (0.5 + rng.random())
            backoff = min(backoff * 2, 8 * ttl)
        except ClientCrash:
            return  # died with its host; this workload has no restarts


def _heartbeat_agent(m):
    """Wraps :meth:`HostMembership.heartbeat_task` so a host death
    (:class:`ClientCrash` from the killer) retires the loop cleanly."""
    try:
        yield from m.heartbeat_task()
    except ClientCrash:
        m.stop()


def _membership_agent(table, store, m, st):
    """One host's monitor *and* successor duties: sweep the member words
    every ``sweep_every``, and when a host this monitor is the rank-order
    successor of goes DEAD, run the epoch-fenced takeover of every shard
    still homed on the corpse.  Detection and crash→re-homed latencies
    land in the run state (dead hosts with no scheduled crash time — a
    partition mirage — are recorded as verdicts only)."""
    clock = table.clock
    detected: set = set()
    try:
        while not m.stopped:
            m.sweep_once()
            for h in range(m.num_hosts):
                if h == m.host or m.estimator.verdict(h) != DEAD:
                    continue
                t0 = st.crash_times.get(h)
                died = m.estimator.died_at(h)
                if t0 is not None and died is not None and h not in detected:
                    detected.add(h)
                    st.detect_latencies.append(died - t0)
                if not m.is_successor(h):
                    continue
                for shard in table.shards:
                    if shard.home_host != h:
                        continue
                    try:
                        rep = table.takeover_shard(
                            m.p, shard.index, store.all_records(),
                            membership=m)
                    except RemoteTimeout:
                        rep = None  # the witness is unreachable too: retry
                    if rep is None:
                        continue
                    now = clock()
                    if t0 is not None:
                        st.takeover_latencies.append(now - t0)
                    st.failover_events.append(
                        [round(now, 9), h, shard.index, rep["epoch"],
                         rep["intact"], rep["reset"]])
            yield m.policy.sweep_every
    except ClientCrash:
        m.stop()


def _host_killer(engine, faults, schedule, tasks_by_host):
    """home_death's reaper: at each instant the host's memory drops off
    the fabric for good (``fail_host``) and every one of its tasks —
    clients, heartbeat, monitor — dies at its next dispatch."""
    for t, host in schedule:
        dt = t - engine.clock.now
        if dt > 0:
            yield dt
        faults.fail_host(host, t)
        for task in tasks_by_host[host]:
            engine.kill(task, ClientCrash("host.death", pid=host))


def _rehome_verifier(mem, table, st, host, keys, ttl, out):
    """The post-run prover: from the successor host, acquire every key the
    dead home used to own.  A key that cannot be granted, or that hands
    out a token at or below the pre-crash maximum, is a failed takeover —
    both feed the run's hard asserts."""
    p = mem.spawn(host)
    for key in keys:
        backoff = ttl / 8
        while True:
            lease = table.try_acquire(p, key, ttl)
            if lease is not None:
                break
            yield backoff  # a pre-crash survivor lease drains within a TTL
            backoff = min(backoff * 2, 4 * ttl)
        if lease.token <= st.last_token.get(key, 0):
            st.token_regressions += 1
        table.release(p, lease)
        out.append(key)
        yield THINK


# ------------------------------------------------------------------ runner
@dataclass
class SimResult:
    """One deterministic sim run.  ``row()`` is the byte-stable record: it
    excludes wall-clock fields (and the live table), so two same-seed runs
    compare equal — the CI determinism gate diffs exactly these rows,
    including every per-mode counter and per-mode per-class cost."""

    workload: str
    num_hosts: int
    clients_per_host: int
    num_shards: int
    seed: int
    target_ops: int
    ops: int
    virtual_seconds: float
    virtual_throughput: float
    jain: float
    grants: int
    rejects: int
    grants_shared: int
    grants_exclusive: int
    rejects_shared: int
    rejects_exclusive: int
    expirations: int
    fast_renews: int
    fast_releases: int
    shared_joins: int
    shared_renews: int
    shared_releases: int
    shared_remote_grants: int
    shared_acquire_rcas: int
    upgrades: int
    downgrades: int
    intent_blocks: int
    repairs: int
    zombie_renews: int
    token_regressions: int
    writer_grants: int
    writer_max_wait: float
    writer_mean_wait: float
    crashes: int
    kills: int
    reclaims: int
    recovery_p50: float
    recovery_p99: float
    recovery_max: float
    recovery_events: List[List[int]]
    reclaim_fast: int
    reclaim_slow: int
    reclaim_shared: int
    reclaim_rejects: int
    orphan_probes: int
    orphan_adopts: int
    reconstructs: int
    reconstruct_resets: int
    takeovers: int
    takeover_refusals: int
    takeover_aborts: int
    epoch_aborts: int
    rehomed_keys: int
    remote_timeouts: int
    guard_blocks: int
    quorum_losses: int
    minority_grants: int
    detect_p99: float
    failover_p50: float
    failover_p99: float
    failover_max: float
    failover_events: List[List]
    fabric: Dict[str, int]
    inflations: int
    deflations: int
    queue_enqueues: int
    queue_grants: int
    queue_handoffs: int
    queue_bypasses: int
    hot_key_report: List[List]
    inflation_events: List[List]
    hot_grants: int
    hot_acquire_p50: float
    hot_acquire_p99: float
    hot_acquire_max: float
    hot_remote_acquires: int
    hot_rcas_mean: float
    hot_rcas_max: int
    sheds: int
    hedges: int
    deadline_exceeded: int
    op_timeouts: int
    fabric_retries: int
    breaker_trips: int
    breaker_refusals: int
    budget_refusals: int
    offered_load: float
    storm_offered: int
    storm_goodput: int
    storm_goodput_shared: int
    storm_shed: int
    storm_deadline_misses: int
    storm_late_grants: int
    storm_acquire_p50: float
    storm_acquire_p99: float
    opt_reads: int
    opt_read_retries: int
    opt_read_fallbacks: int
    opt_read_fwd: int
    publishes: int
    reads: int
    pipeline_flushes: int
    pipeline_flushed_ops: int
    pipeline_hedge_rides: int
    doorbells_per_op: float
    cost: Dict[str, Dict[str, int]]
    mode_cost: Dict[str, Dict[str, int]]
    events: int
    spins: int
    wall_seconds: float
    per_client: List[int] = field(repr=False)
    table: ShardedLockTable = field(repr=False)

    def row(self) -> Dict:
        drop = {"wall_seconds", "per_client", "table"}
        return {k: v for k, v in vars(self).items() if k not in drop}


def run_lock_table_sim(
    workload: str,
    num_hosts: int = 64,
    clients_per_host: int = 16,
    num_shards: Optional[int] = None,
    total_ops: int = 100_000,
    seed: int = 0,
    ttl: Optional[float] = None,
    latency: Optional[FabricLatency] = None,
    zipf_s: float = 0.99,
    keys_per_host: int = KEYS_PER_HOST,
    crash_prob: float = 0.1,
    write_frac: float = 0.05,
    home_frac: float = 0.8,
    shared_reads: bool = True,
    read_path: str = "lease",
    pipeline_flush_ops: int = 8,
    hold: float = HOLD,
    hot_keys: Optional[int] = None,
    failover_ttl: float = 300e-6,
    fault: Optional[FaultInjector] = None,
    crash_hosts: int = 8,
    crash_warmup: Optional[float] = None,
    crash_spacing: Optional[float] = None,
    restart_delay: Optional[float] = None,
    reclaim: bool = True,
    inflation: Optional[InflationPolicy] = None,
    member_ttl: Optional[float] = None,
    partition_frac: float = 0.25,
    partition_at: Optional[float] = None,
    partition_for: Optional[float] = None,
    offered_load: float = 1.0,
    deadline_budget: Optional[float] = None,
    storm_interarrival: float = STORM_INTERARRIVAL,
    overload: Optional[OverloadPolicy] = None,
    shedding: bool = True,
    congest_capacity: Optional[int] = None,
    congest_delay: float = 12e-6,
    drop_prob: float = 0.0,
    max_events: Optional[int] = None,
) -> SimResult:
    """Run one workload to ``total_ops`` granted leases; fully deterministic.

    Returns exact per-class and per-mode operation counts (``cost`` /
    ``mode_cost``) plus virtual-time throughput and fairness.  Raises if any
    safety invariant breaks: the LOCAL class must never issue an RDMA op,
    writer grant tokens must be strictly monotonic per key (reader
    generations may only equal the running maximum, never regress), no
    zombie renewal may survive fencing, and in ``reader_flood`` the queued
    writer's grant latency must stay bounded by the drain protocol.
    """
    if workload not in SIM_WORKLOADS:
        raise ValueError(f"unknown sim workload {workload!r}")
    if read_path not in ("lease", "optimistic"):
        raise ValueError(f"unknown read_path {read_path!r}")
    wall0 = time.perf_counter()
    engine = SimEngine(seed)
    if ttl is None:
        # The short-lease workloads share one tunable TTL (``failover_ttl``)
        # instead of a hardcoded constant, so the recovery sweeps can scale
        # lease lifetime without forking the workload.
        short = ("failover", "reader_flood", "crash_restart",
                 "home_death", "partition", "overload_storm")
        ttl = failover_ttl if workload in short else 1.0
        if workload == "overload_storm":
            # The storm's TTL is its *contention quantum*: inside one
            # atomic blocking acquire a contended word can only free by
            # expiry (the holder's release step cannot interleave), so
            # the TTL prices each contended retry round, not lease
            # safety.  Keep it well under the deadline budget.
            ttl = failover_ttl / 5
    # Membership TTL: long enough that one monitor sweep (num_hosts-1
    # charged probes) fits well inside a sweep period — the detector's
    # cadence must not be slower than its own probe loop.
    if member_ttl is None:
        member_ttl = max(10 * ttl, num_hosts * 100e-6)

    # The fault plan: home_death needs `fail_host`, partition needs the
    # scheduled cut, and ANY workload with a FaultInjector gets the fabric
    # points armed (the crash matrix crosses host-crash cells with
    # message-loss cells through exactly this wiring).  Everything else
    # keeps faults=None and the legacy loss-free timelines byte-identical.
    minority: Optional[frozenset] = None
    window = None
    faults: Optional[FabricFaults] = None
    if workload == "partition":
        q = max(1, int(num_hosts * partition_frac))
        minority = frozenset(range(q))
        t0 = partition_at if partition_at is not None else 2 * member_ttl
        t1 = t0 + (partition_for if partition_for is not None
                   else 4 * member_ttl)
        window = (t0, t1)
        faults = FabricFaults(seed=seed, injector=fault,
                              partitions=((minority, t0, t1),))
    elif workload == "overload_storm":
        # The storm *requires* a fault plan: congestion is what makes
        # overload cost latency.  One remote acquire+release lands ~11
        # postings on the key's home, so at the base interarrival each
        # host sees ~20 postings per 200us window per 4 clients; 12 per
        # client leaves 1x at ~40% of capacity and 10x several times over.
        if congest_capacity is None:
            congest_capacity = 12 * clients_per_host
        faults = FabricFaults(seed=seed, injector=fault,
                              drop_prob=drop_prob,
                              congest_capacity=congest_capacity,
                              congest_delay=congest_delay)
    elif (workload == "home_death" or fault is not None
          or congest_capacity is not None or drop_prob > 0.0):
        faults = FabricFaults(seed=seed, injector=fault,
                              drop_prob=drop_prob,
                              congest_capacity=congest_capacity,
                              congest_delay=congest_delay)
    mem = SimFabricMemory(num_hosts, engine, latency or FabricLatency(),
                          faults=faults)
    table = ShardedLockTable(
        mem, num_shards=num_shards or 2 * num_hosts,
        clock=engine.clock, sleep=engine.sleep_inline, name=f"sim{seed}",
        fault=fault, inflation=inflation, seed=seed, overload=overload,
    )

    universe = [f"k/{i}" for i in range(num_hosts * keys_per_host)]
    if workload == "home":
        per_host = keys_by_home(table, num_hosts, keys_per_host)
        pick_for = lambda h: lambda rng: rng.choice(per_host[h])  # noqa: E731
    elif workload == "uniform":
        pick_for = lambda h: lambda rng: rng.choice(universe)  # noqa: E731
    elif workload == "zipfian":
        zipf = _zipf_picker(universe, zipf_s)
        pick_for = lambda h: zipf  # noqa: E731
    elif workload == "read_heavy":
        # home_frac of each client's draws are zipfian over its OWN host's
        # keys (the zero-RDMA class), the rest zipfian over the universe
        # (remote shared traffic — the one-rCAS joins the sweep prices).
        per_host = keys_by_home(table, num_hosts, keys_per_host)
        home_zipf = {h: _zipf_picker(ks, zipf_s)
                     for h, ks in per_host.items()}
        global_zipf = _zipf_picker(universe, zipf_s)

        def pick_for(h):  # noqa: E306
            hz = home_zipf[h]

            def pick(rng: random.Random) -> str:
                return hz(rng) if rng.random() < home_frac else global_zipf(rng)

            return pick
    elif workload == "pipelined_read":
        # Burst targets: each reader aims a whole burst at one remote
        # host's keys, so the AsyncClient can coalesce it into a single
        # posting; the per-host writer mutates its own (home-class) keys.
        per_host = keys_by_home(table, num_hosts, keys_per_host)
        pick_for = None  # clients draw from per_host directly
    elif workload == "reader_flood":
        pick_for = None  # flood clients share one literal key
    elif workload == "home_death":
        # Uniform over the whole keyspace: the dead home's keys must keep
        # seeing traffic, or the takeover would never be exercised.
        pick_for = lambda h: lambda rng: rng.choice(universe)  # noqa: E731
    elif workload == "partition":
        # Every draw is majority-homed, so a minority client's acquire
        # must cross the cut — the zero-in-window-grants assert is about
        # the guard and the fabric, not about idle clients.
        majority_keys = [k for k in universe
                         if table.home_of(k) not in minority]
        pick_for = lambda h: lambda rng: rng.choice(majority_keys)  # noqa: E731
    elif workload == "overload_storm":
        # Uniform over the universe: at 1x each key is nearly idle and
        # each host well under its posting capacity; at 10x the SAME
        # keyspace is contended and the SAME hosts congested — overload
        # emerges from load alone, not from a skew knob.
        pick_for = lambda h: lambda rng: rng.choice(universe)  # noqa: E731
    else:  # failover / crash_restart: everyone storms a small hot set
        # The hot-set size is a workload parameter (``hot_keys``), not a
        # baked-in constant — the recovery sweep narrows it to sharpen
        # contention on the crashed holders' keys.
        hot = universe[: (hot_keys or max(4, num_hosts))]
        pick_for = lambda h: lambda rng: rng.choice(hot)  # noqa: E731

    nclients = num_hosts * clients_per_host
    st = _RunState(nclients, total_ops)
    pipes: List[AsyncClient] = []
    st.minority = minority
    st.window = window
    flood_key = universe[0]
    store = LedgerStore()
    if restart_delay is None:
        restart_delay = ttl / 4
    tasks_by_host: Dict[int, List] = {h: [] for h in range(num_hosts)}

    # Storm pacing: the *base* (1x) interarrival sets the measurement
    # window (so every offered-load point observes the same virtual-time
    # span), and the actual per-client interarrival divides by the load —
    # 10x offered load is 10x the arrivals into the SAME window.
    storm_until = 0.0
    storm_ia = storm_interarrival
    if workload == "overload_storm":
        if deadline_budget is None:
            deadline_budget = 10 * ttl
        storm_ia = storm_interarrival / max(offered_load, 1e-9)
        storm_until = total_ops * storm_interarrival / max(nclients, 1)

    memberships: List[HostMembership] = []
    run_until = 0.0
    if workload in ("home_death", "partition"):
        if window is not None:
            run_until = window[1] + 4 * member_ttl
        # One heartbeat + one monitor per host.  The heartbeats ride the
        # RecoverableClient ledger path (a member shard that gets taken
        # over keeps its fencing history); the monitors start half a
        # membership TTL late so first beats land before first sweeps.
        mpol = SuspicionPolicy(ttl=member_ttl)
        for h in range(num_hosts):
            m = HostMembership(table, mem, h, num_hosts, policy=mpol,
                               ledger=store.ledger(f"member.h{h}"))
            memberships.append(m)
            hb = _heartbeat_agent(m)
            mon = _membership_agent(table, store, m, st)
            tasks_by_host[h] += [hb, mon]
            engine.spawn(hb, delay=h * 1e-7)
            engine.spawn(mon, delay=member_ttl / 2 + h * 1e-7)

    for idx in range(nclients):
        host = idx // clients_per_host
        rng = random.Random(1_000_003 * seed + idx)
        if workload in ("home_death", "partition"):
            member = memberships[host]
            task = _ha_client(mem, table, store, host, idx, rng,
                              pick_for(host), st, ttl, member=member,
                              run_until=run_until)
            tasks_by_host[host].append(task)
            engine.spawn(task, delay=idx * 1e-7)
            continue
        if workload == "crash_restart":
            # The recoverable client spawns its own Process (and respawns
            # one per restart); the reaper needs the task handle to kill.
            task = _recoverable_client(mem, table, store, host, idx, rng,
                                       pick_for(host), st, ttl,
                                       restart_delay, reclaim)
            tasks_by_host[host].append(task)
            engine.spawn(task, delay=idx * 1e-7)
            continue
        p = mem.spawn(host)
        if workload == "failover":
            task = _failover_client(table, p, rng, pick_for(host), st, idx,
                                    ttl, crash_prob)
        elif workload == "read_heavy":
            if read_path == "optimistic":
                task = _opt_mix_client(table, p, rng, pick_for(host), st,
                                       idx, ttl, write_frac, hold)
            else:
                task = _mode_mix_client(table, p, rng, pick_for(host), st,
                                        idx, ttl, write_frac, shared_reads,
                                        hold)
        elif workload == "pipelined_read":
            pl = AsyncClient(table, p, flush_ops=pipeline_flush_ops)
            pipes.append(pl)
            task = _pipelined_read_client(
                table, pl, rng, st, idx, ttl, per_host, host, num_hosts,
                idx % clients_per_host == 0, pipeline_flush_ops)
        elif workload == "reader_flood":
            if idx == 0:
                task = _flood_writer(table, p, rng, st, idx, flood_key, ttl)
            else:
                task = _flood_reader(table, p, rng, st, idx, flood_key, ttl)
        elif workload == "zipfian":
            # universe[0] is zipf rank 1: the hottest key, the one whose
            # acquire-latency tail and per-acquire rCAS the gates bound.
            task = _sticky_hot_client(table, p, rng, pick_for(host), st,
                                      idx, ttl, (universe[0],))
        elif workload == "overload_storm":
            # Every 4th client is the SHARED reader at priority 1 — the
            # brownout witness.  Writers shed at priority 0 (or never,
            # in the shedding-OFF control leg).
            task = _storm_client(table, p, rng, pick_for(host), st, idx,
                                 ttl, deadline_budget, storm_ia,
                                 idx % 4 == 3, shedding, storm_until)
        else:
            task = _acquire_release_client(table, p, rng, pick_for(host), st,
                                           idx, ttl)
        engine.spawn(task, delay=idx * 1e-7)  # deterministic arrival stagger

    if workload == "crash_restart":
        # The crash schedule is seeded data, independent of the engine RNG:
        # host choice and crash instants depend only on the run seed.
        crash_rng = random.Random(0xC0FFEE * (seed + 1))
        victims = crash_rng.sample(range(num_hosts),
                                   min(crash_hosts, num_hosts))
        warmup = crash_warmup if crash_warmup is not None else 20 * ttl
        spacing = crash_spacing if crash_spacing is not None else ttl / 2
        schedule = [(warmup + i * spacing, h) for i, h in enumerate(victims)]
        engine.spawn(_crash_reaper(engine, schedule, tasks_by_host))

    dead_host = None
    dead_shard_idxs: set = set()
    if workload == "home_death":
        # Seeded like the crash_restart schedule: same seed, same corpse,
        # same instant.  The successor of the dead host must survive to
        # run the takeover, so exactly one host dies.
        crash_rng = random.Random(0xC0FFEE * (seed + 1))
        dead_host = crash_rng.randrange(num_hosts)
        crash_at = (crash_warmup if crash_warmup is not None
                    else 2 * member_ttl)
        st.crash_times[dead_host] = crash_at
        dead_shard_idxs = {s.index for s in table.shards
                           if s.home_host == dead_host}
        engine.spawn(_host_killer(engine, faults, [(crash_at, dead_host)],
                                  tasks_by_host))

    if workload == "home_death":
        # The ops target alone must not end the run mid-funeral: hold it
        # open until every shard of the dead home has a new one.
        stop = lambda: (st.done() and all(  # noqa: E731
            s.home_host != dead_host for s in table.shards))
    elif workload == "partition":
        t_end = window[1] + 2 * member_ttl
        stop = lambda: st.done() and engine.clock.now > t_end  # noqa: E731
    elif workload == "overload_storm":
        # Open loop: the run ends when the window does (clients retire at
        # their first arrival past it), never on an ops target.  The
        # clock bound is a backstop for stragglers draining their last
        # transaction.
        stop = lambda: engine.clock.now > storm_until + 8 * ttl  # noqa: E731
    else:
        stop = st.done
    engine.run(stop=stop,
               max_events=max_events or (200 * total_ops + 500_000))

    if workload in ("home_death", "partition"):
        for m in memberships:
            m.stop()
    if workload == "home_death":
        # Second phase: prove the takeover from the outside.  Every key
        # the dead home used to own must be grantable from the successor,
        # with a token above the pre-crash maximum.
        dead_keys = [k for k in universe
                     if table.shard_of(k) in dead_shard_idxs]
        if dead_shard_idxs:
            succ = table.shards[min(dead_shard_idxs)].home_host
            verified: List[str] = []
            engine.spawn(_rehome_verifier(mem, table, st, succ, dead_keys,
                                          ttl, verified))
            engine.run(stop=lambda: len(verified) == len(dead_keys),
                       max_events=500_000)
            if len(verified) != len(dead_keys):
                raise AssertionError(
                    f"home_death: only {len(verified)}/{len(dead_keys)} "
                    f"keys of dead host {dead_host} re-homed")
    wall = time.perf_counter() - wall0

    totals = table.class_totals()
    mode_totals = table.mode_class_totals()
    if totals[LOCAL].rdma_ops:
        raise AssertionError(
            f"{workload}: LOCAL class issued {totals[LOCAL].rdma_ops} RDMA ops"
        )
    if workload == "home" and totals[REMOTE].rdma_ops:
        raise AssertionError(
            f"home: placement-aware clients issued "
            f"{totals[REMOTE].rdma_ops} remote ops"
        )
    if st.token_regressions:
        raise AssertionError(
            f"{workload}: {st.token_regressions} fencing-token regressions"
        )
    if st.zombie_renews:
        raise AssertionError(
            f"{workload}: {st.zombie_renews} zombie renewals survived fencing"
        )

    rows = table.telemetry()
    grants_shared = sum(r["grants_shared"] for r in rows)
    grants_exclusive = sum(r["grants_exclusive"] for r in rows)
    if grants_shared + grants_exclusive != sum(r["grants"] for r in rows):
        raise AssertionError(
            f"{workload}: per-mode grant counters do not partition the "
            f"total ({grants_shared} + {grants_exclusive} != "
            f"{sum(r['grants'] for r in rows)})"
        )
    if workload in ("home", "uniform", "zipfian", "failover",
                    "home_death", "partition") and grants_shared:
        raise AssertionError(
            f"{workload}: exclusive-only workload produced {grants_shared} "
            "shared grants"
        )
    takeovers = sum(r["takeovers"] for r in rows)
    takeover_refusals = sum(r["takeover_refusals"] for r in rows)
    if workload == "home_death" and dead_shard_idxs:
        if takeovers != len(dead_shard_idxs):
            raise AssertionError(
                f"home_death: {takeovers} takeovers committed for "
                f"{len(dead_shard_idxs)} shards homed on dead host "
                f"{dead_host}")
        p99 = _pct(st.takeover_latencies, 0.99)
        if p99 > 5 * member_ttl:
            raise AssertionError(
                f"home_death: crash->re-homed p99 {p99:.6f}s exceeds 5x "
                f"membership TTL ({5 * member_ttl:.6f}s)")
    if workload == "partition":
        if st.minority_grants:
            raise AssertionError(
                f"partition: {st.minority_grants} grants landed on the "
                f"minority side inside the cut window")
        if not takeover_refusals:
            raise AssertionError(
                "partition: the guard never refused a takeover — the "
                "window was too quiet to test anything")
        if not any(m.quorum_losses for m in memberships):
            raise AssertionError(
                "partition: no monitor ever lost quorum — the cut "
                "never bit")
    inflations = sum(r["inflations"] for r in rows)
    deflations = sum(r["deflations"] for r in rows)
    if inflation is None and (inflations or deflations):
        raise AssertionError(
            f"{workload}: inflation disabled but the table recorded "
            f"{inflations} inflations / {deflations} deflations"
        )
    writer_waits = st.writer_waits
    if workload == "reader_flood":
        if not writer_waits:
            raise AssertionError("reader_flood: the writer never got a grant")
        # The drain protocol's bound: intent is armed at the writer's first
        # blocked CS, the cohort stops extending, and the writer wins within
        # ~one TTL (+ polling slack).  10x is a loud failure margin, not a
        # tight model.
        if max(writer_waits) > 10 * ttl:
            raise AssertionError(
                f"reader_flood: writer starved — max wait "
                f"{max(writer_waits):.6f}s vs ttl {ttl}"
            )

    doorbells = (totals[LOCAL].remote_doorbell
                 + totals[REMOTE].remote_doorbell)
    doorbells_per_op = doorbells / max(st.total, 1)
    opt_reads = sum(r["opt_reads"] for r in rows)
    if workload == "pipelined_read":
        if not opt_reads:
            raise AssertionError(
                "pipelined_read: no optimistic read ever completed")
        # flush_ops=1 posts every op the moment it is enqueued — that is
        # the bench's unbatched control leg, exempt from the coalescing
        # bound it exists to contrast against.
        if pipeline_flush_ops > 1 and doorbells_per_op >= 1.0:
            raise AssertionError(
                f"pipelined_read: {doorbells_per_op:.2f} doorbells/op — "
                "the pipeline failed to coalesce below one per operation")

    orep = table.overload.report() if table.overload is not None else {}
    vsec = engine.clock.now
    return SimResult(
        workload=workload,
        num_hosts=num_hosts,
        clients_per_host=clients_per_host,
        num_shards=table.num_shards,
        seed=seed,
        target_ops=total_ops,
        ops=st.total,
        virtual_seconds=vsec,
        virtual_throughput=st.total / max(vsec, 1e-12),
        jain=jain(st.per_client),
        grants=sum(r["grants"] for r in rows),
        rejects=sum(r["rejects"] for r in rows),
        grants_shared=grants_shared,
        grants_exclusive=grants_exclusive,
        rejects_shared=sum(r["rejects_shared"] for r in rows),
        rejects_exclusive=sum(r["rejects_exclusive"] for r in rows),
        expirations=sum(r["expirations"] for r in rows),
        fast_renews=sum(r["fast_renews"] for r in rows),
        fast_releases=sum(r["fast_releases"] for r in rows),
        shared_joins=sum(r["shared_joins"] for r in rows),
        shared_renews=sum(r["shared_renews"] for r in rows),
        shared_releases=sum(r["shared_releases"] for r in rows),
        shared_remote_grants=sum(r["shared_remote_grants"] for r in rows),
        shared_acquire_rcas=sum(r["shared_acquire_rcas"] for r in rows),
        upgrades=sum(r["upgrades"] for r in rows),
        downgrades=sum(r["downgrades"] for r in rows),
        intent_blocks=sum(r["intent_blocks"] for r in rows),
        repairs=sum(r["repairs"] for r in rows),
        zombie_renews=st.zombie_renews,
        token_regressions=st.token_regressions,
        writer_grants=len(writer_waits),
        writer_max_wait=max(writer_waits) if writer_waits else 0.0,
        writer_mean_wait=(sum(writer_waits) / len(writer_waits)
                          if writer_waits else 0.0),
        crashes=st.crashes,
        kills=engine.kills,
        reclaims=st.reclaims,
        recovery_p50=_pct(st.recovery_latencies, 0.50),
        recovery_p99=_pct(st.recovery_latencies, 0.99),
        recovery_max=(max(st.recovery_latencies)
                      if st.recovery_latencies else 0.0),
        recovery_events=st.recovery_events,
        reclaim_fast=sum(r["reclaim_fast"] for r in rows),
        reclaim_slow=sum(r["reclaim_slow"] for r in rows),
        reclaim_shared=sum(r["reclaim_shared"] for r in rows),
        reclaim_rejects=sum(r["reclaim_rejects"] for r in rows),
        orphan_probes=sum(r["orphan_probes"] for r in rows),
        orphan_adopts=sum(r["orphan_adopts"] for r in rows),
        reconstructs=sum(r["reconstructions"] for r in rows),
        reconstruct_resets=sum(r["reconstruct_resets"] for r in rows),
        takeovers=takeovers,
        takeover_refusals=takeover_refusals,
        takeover_aborts=sum(r["takeover_aborts"] for r in rows),
        epoch_aborts=sum(r["epoch_aborts"] for r in rows),
        rehomed_keys=sum(r["rehomed_keys"] for r in rows),
        remote_timeouts=st.remote_timeouts,
        guard_blocks=sum(m.guard_blocks for m in memberships),
        quorum_losses=sum(m.quorum_losses for m in memberships),
        minority_grants=st.minority_grants,
        detect_p99=_pct(st.detect_latencies, 0.99),
        failover_p50=_pct(st.takeover_latencies, 0.50),
        failover_p99=_pct(st.takeover_latencies, 0.99),
        failover_max=(max(st.takeover_latencies)
                      if st.takeover_latencies else 0.0),
        failover_events=st.failover_events,
        fabric=dict(faults.stats) if faults is not None else {},
        inflations=inflations,
        deflations=deflations,
        queue_enqueues=sum(r["queue_enqueues"] for r in rows),
        queue_grants=sum(r["queue_grants"] for r in rows),
        queue_handoffs=sum(r["queue_handoffs"] for r in rows),
        queue_bypasses=sum(r["queue_bypasses"] for r in rows),
        hot_key_report=table.hot_keys(10),
        inflation_events=table.inflation_log(),
        hot_grants=len(st.hot_latencies),
        hot_acquire_p50=_pct(st.hot_latencies, 0.50),
        hot_acquire_p99=_pct(st.hot_latencies, 0.99),
        hot_acquire_max=(max(st.hot_latencies)
                         if st.hot_latencies else 0.0),
        hot_remote_acquires=len(st.hot_rcas),
        hot_rcas_mean=(sum(st.hot_rcas) / len(st.hot_rcas)
                       if st.hot_rcas else 0.0),
        hot_rcas_max=max(st.hot_rcas) if st.hot_rcas else 0,
        sheds=sum(r["sheds"] for r in rows),
        hedges=sum(r["hedges"] for r in rows),
        deadline_exceeded=sum(r["deadline_exceeded"] for r in rows),
        op_timeouts=sum(r["timeouts"] for r in rows),
        fabric_retries=sum(r["fabric_retries"] for r in rows),
        breaker_trips=orep.get("breaker_trips", 0),
        breaker_refusals=orep.get("breaker_refusals", 0),
        budget_refusals=orep.get("budget_refusals", 0),
        offered_load=offered_load,
        storm_offered=st.offered,
        storm_goodput=st.goodput,
        storm_goodput_shared=st.goodput_shared,
        storm_shed=st.shed_ops,
        storm_deadline_misses=st.deadline_misses,
        storm_late_grants=st.late_grants,
        storm_acquire_p50=_pct(st.storm_latencies, 0.50),
        storm_acquire_p99=_pct(st.storm_latencies, 0.99),
        opt_reads=opt_reads,
        opt_read_retries=sum(r["opt_read_retries"] for r in rows),
        opt_read_fallbacks=sum(r["opt_read_fallbacks"] for r in rows),
        opt_read_fwd=sum(r["opt_read_fwd"] for r in rows),
        publishes=sum(r["publishes"] for r in rows),
        reads=st.reads,
        pipeline_flushes=sum(pl.stats["flushes"] for pl in pipes),
        pipeline_flushed_ops=sum(pl.stats["flushed_ops"] for pl in pipes),
        pipeline_hedge_rides=sum(pl.stats["hedge_rides"] for pl in pipes),
        doorbells_per_op=doorbells_per_op,
        cost={"local": vars(totals[LOCAL]).copy(),
              "remote": vars(totals[REMOTE]).copy()},
        mode_cost={
            f"{mode.label}_{cls_name}": vars(mode_totals[mode][cls]).copy()
            for mode in LeaseMode
            for cls_name, cls in (("local", LOCAL), ("remote", REMOTE))
        },
        events=engine.events,
        spins=engine.spins,
        wall_seconds=wall,
        per_client=st.per_client,
        table=table,
    )
