"""Sharded asymmetric lock table: the paper's per-class cost optimality,
applied to a whole keyspace instead of one record.

A single :class:`~repro_torch.core.ALock` makes exactly one host the privileged
"local" class; everyone else pays fabric operations.  That is the right shape
for one hot record, but a control plane serving millions of keys wants the
privilege *spread out*: partition the keyspace into ``num_shards`` shards,
home shard ``s`` on host ``s % num_hosts`` (a stable hash, so placement never
depends on interpreter state), and guard each shard's lease metadata with its
own ALock.  Every host is then the zero-RDMA local class for its slice of the
keyspace, and the paper's cost claims hold *per shard*: a client transacting
on keys homed on its own host issues **zero** simulated RDMA operations, and
a remote client pays the ALock's bounded budget.

Layered on the shard locks is a **lease table** (the long-lived exclusion):

* ``try_acquire(p, key, ttl)`` grants a :class:`Lease` with a monotonically
  increasing **fencing token** per key.  The shard's ALock is held only for
  the short metadata transaction — the lease itself is what excludes other
  clients, so a crashed holder can never wedge the shard: its lease expires
  after ``ttl`` and the next grant carries a larger token, which downstream
  resources use to reject the crashed holder's stale writes.
* ``acquire_batch(p, keys, ttl)`` takes multiple leases in the **global key
  order** ``(shard_of(key) % num_hosts, shard_of(key), key)``.  All batched
  clients walk the same total order, so no cycle of waiters can form —
  deadlock freedom without a detector (see ``docs/lock-table.md``); the
  static-home-major ordering additionally puts same-home shard groups next
  to each other, so a batch chains their WR lists into one posting per
  destination host.

**Lease modes** (see the "Lease modes" section of ``docs/lock-table.md``):
every lease is either :data:`LeaseMode.EXCLUSIVE` (one writer) or
:data:`LeaseMode.SHARED` (a cohort of readers).  The per-key expiry register
packs ``(writer_fence_token, reader_count, expires_at)`` so that a shared
grant is a *single CAS* on one word — readers never take the shard ALock at
all: zero simulated RDMA ops for a home-host reader, one rCAS per attempt
for a remote one (exactly one uncontended and under the sim engine's atomic
steps; a threaded CAS race retries, bounded by the fast-attempt cap).  Reader generations reuse the last CS-allocated token (readers
issue no fenced downstream writes), writer grants still allocate strictly
increasing tokens inside the critical section, and a queued writer **drains**
a live reader cohort through a lease-like intent barrier: new joins and
shared renewals are refused while the barrier is armed, so the cohort dries
up within one TTL and the writer's grant latency is bounded.

Hot-path optimisations (see the "Hot path" section of ``docs/lock-table.md``):

* **Renewal/release fast path** — the current holder extends or drops its
  lease with a single fencing-token-checked CAS on the expiry register,
  *without* taking the shard ALock: zero simulated RDMA ops for local
  holders, exactly one rCAS for remote holders.  The expiry register packs
  ``(fence_token, readers, expires_at)`` so the CAS validates the fence: a
  zombie holder's CAS always loses after a re-grant (the token moved on).
* **Shard-grouped batches** — ``acquire_batch`` holds each shard's ALock
  once for all of that shard's keys (O(distinct shards) critical sections
  instead of O(keys)), still walking the global order; ``release_batch``
  mirrors it, coalescing a shard group's release CASes into one doorbell
  and taking the shard ALock at most once for the group's slow-path leases.
* **Doorbell coalescing** — remote clients post the critical section's
  register reads in one :meth:`~repro_torch.core.AsymmetricMemory.post_batch`
  doorbell and its writes in another, modelling RDMA WR posting lists.

Telemetry: every table operation snapshots the calling process's
:class:`~repro_torch.core.OpCounts` (an O(1) tuple snapshot, accumulated in place —
no per-op dict copies) and adds the delta to the target shard's per-class
(LOCAL/REMOTE) totals — and, since the mode refactor, to the per-mode
per-class totals — so benchmarks and the serving layer can verify the
zero-RDMA home path *per mode* without instrumenting clients.
"""

from __future__ import annotations

import enum
import hashlib
import random
import threading
import time
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import (ALock, AsymmetricMemory, DeadlineExceeded,
                        InflatedKeyQueue, OpCounts, Overloaded, Process,
                        RemoteTimeout, TIMEOUT)

from .faults import FaultInjector
from .inflation import ContentionEstimator, InflationPolicy
from .overload import OverloadControl, OverloadPolicy

LOCAL, REMOTE = 0, 1

_NO_HOLDER = -1

# The expiry register packs (fence_token, reader_count, expires_at).
# expires_at <= FREE_AT means the key is not held (never granted, or
# released); a grant always writes a strictly positive expiry, so the states
# cannot be confused.
_FREE_AT = 0.0

# Bounded optimism: the shared-mode fast paths are read+CAS retry loops (the
# CAS can lose only to another *successful* shared operation, so the system
# as a whole always progresses).  Under the sim engine's atomic steps a
# retry never happens; under threads the cap converts a pathological
# contention storm into a clean reject instead of an unbounded spin.
_FAST_ATTEMPTS = 64

# Seeded exponential backoff for the blocking acquire loops: `poll` is the
# base, doubling per reject up to this many base intervals, with +-50%
# seeded jitter — the thundering-herd fix for threaded hot keys, routed
# through the injected clock/RNG so the sim stays deterministic.
_BACKOFF_CAP_POLLS = 32

# Optimistic (seqlock) read attempts before falling back to a shared lease:
# each attempt is one doorbell for a remote reader (zero for a home one),
# so the cap bounds the read's worst-case fabric cost at a handful of
# doorbells before it degrades to the still-cheap shared join.
_OPT_ATTEMPTS = 8

# Feasibility-shed safety margin: an acquire is refused once its remaining
# deadline budget drops below this multiple of the shard's observed
# time-to-completion EWMA.  The EWMA is a *mean*; completion times are
# right-skewed (a contended word only frees on TTL expiry), so admitting
# everything above the mean still burns budget on ~half the borderline
# arrivals.  A modest margin sheds those early — a fast local refusal —
# without touching fresh, feasible work (whose remaining budget is several
# multiples of the EWMA).
_SHED_SVC_MARGIN = 1.5

# Tombstone word written (best-effort) into a deposed home's key registers
# by takeover_shard: a generation no fence ever allocates, under an expiry
# that never lapses — a zombie that still reads the old word sees "held
# forever" and can never grant from it.  The old holder register carries
# the forwarding pointer, encoded below (ordinary pids are >= 0 and the
# free sentinel is -1, so forwarded values -2, -3, ... are unambiguous).
_TOMB_TOKEN = 1 << 62
_TOMB_AT = float("inf")


def _fwd_enc(home: int) -> int:
    """Encode a forwarding pointer for a tombstoned holder register."""
    return -(home + 2)


def forwarded_home(holder: int) -> Optional[int]:
    """Decode a tombstoned holder register's forwarding pointer, or None."""
    return -holder - 2 if holder <= -2 else None


# --------------------------------------------------------- word mode encoding
# The packed word stays one register, (token, readers, expires_at); the
# inflation mode bit rides the READERS field as a two's-complement style
# encoding: readers >= 0 is the classic deflated key with that many live
# readers, readers < 0 is an INFLATED key carrying (-readers - 1) live
# readers (so -1 = inflated + zero readers).  Properties this buys:
#
# * the word stays CAS-only and exactly as wide — every existing witness
#   tuple still works, and the mode transition is ONE CAS that changes
#   neither token nor expiry (an atomic mode swing);
# * every deflated-mode fast-path witness has readers == 0 (or > 0 for
#   cohorts), so it can NEVER accidentally match an inflated word: a
#   zombie whose key inflated under it falls off the fast path and lands
#   in the fully-validated slow path, exactly like a fenced-out zombie;
# * shared reader cohorts keep working while inflated — joins/leaves
#   increment/decrement through the encoding, the writer drain barrier is
#   unchanged.
def _infl(readers: int) -> bool:
    """Is this readers-field value inflated-mode?"""
    return readers < 0


def _dec(readers: int) -> int:
    """Decoded live-reader count, either mode."""
    return -readers - 1 if readers < 0 else readers


def _enc(count: int, inflated: bool) -> int:
    """Encode a live-reader count into the given mode."""
    return -count - 1 if inflated else count


# Fencing-token block reserved by the FIRST critical-section grant on an
# inflated key (not at inflation itself — the pre-inflation holder's lease
# still witnesses ``fence == token`` and must stay releasable): the fence
# register jumps to ``token + _INFL_RESERVE`` (the epoch's CEILING) and the
# direct-handoff chain allocates word tokens UNDER it (each handoff CAS
# writes token + 1, chained through the word itself, so monotonicity needs
# no register round-trip).  Every later CS grant on the inflated key
# allocates ceiling + 1 and re-reserves.  2^20 handoffs per reservation:
# far past any queue tenure, and exhaustion just falls back to a CS grant.
_INFL_RESERVE = 1 << 20


def _trusted(etok: int, fence: int, readers: int) -> bool:
    """Mirror-trust check for the packed word against the fence register.

    Deflated: exact match (any skew means a zombie's piggybacked writes hit
    the mirror — untrusted, repaired via the CS).  Inflated: the fence
    register holds the inflation epoch's reserved ceiling and word tokens
    are allocated *under* it by the direct-handoff chain, so trusted means
    ``etok <= fence``.  A deflated word under a still-raised fence
    (etok < fence, readers >= 0) is the post-deflation state: deliberately
    untrusted, so the next CS grant repairs it with token ``ceiling + 1``
    — which is how the fence mirror re-synchronises after an epoch."""
    return etok <= fence if _infl(readers) else etok == fence


class LeaseMode(enum.IntEnum):
    """S/X lease modes.  SHARED leases form a reader cohort on one packed
    word; EXCLUSIVE leases are the original writer leases."""

    SHARED = 0
    EXCLUSIVE = 1

    @property
    def label(self) -> str:
        return "shared" if self is LeaseMode.SHARED else "exclusive"


SHARED, EXCLUSIVE = LeaseMode.SHARED, LeaseMode.EXCLUSIVE


@lru_cache(maxsize=1 << 17)
def stable_key_hash(key: str) -> int:
    """A process-stable 64-bit hash (Python's ``hash`` is salted per run).

    Cached: placement hashing of a hot key must not recompute blake2b on
    every operation (the cache is per-process and placement is stable, so
    memoisation can never change an answer).
    """
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


@dataclass(frozen=True)
class Lease:
    """A granted lease: the unit of long-lived exclusion (or sharing).

    ``token`` is the fencing token — strictly increasing per key across
    *writer* grants, so any resource that records the largest token it has
    seen can reject writes from a holder whose lease has expired and been
    re-granted.  A SHARED lease carries its reader generation's token (the
    last token the critical section allocated): readers issue no fenced
    downstream writes, and the next writer's token is strictly larger than
    every reader generation it displaces.

    ``expires_at`` doubles as the fast-path CAS witness for EXCLUSIVE
    leases: ``renew``/``release`` compare-and-swap the expiry register
    against ``(token, 0, expires_at)``, so hold on to the *latest* lease
    returned by acquire/renew (the :class:`~repro_torch.coord.CoordinationService`
    lease cache does this for you, keyed per mode).  For SHARED leases it is
    the holder's own validity horizon — the packed word tracks the cohort's
    maximum.
    """

    key: str
    shard: int
    holder_pid: int
    token: int
    expires_at: float
    ttl: float
    mode: LeaseMode = LeaseMode.EXCLUSIVE
    # The key's word was in inflated (queued) mode when this lease was
    # granted/renewed: the fast-path witnesses must encode the mode bit
    # (readers == -1, not 0) or they would never match the word again.
    inflated: bool = False

    def witness(self) -> tuple:
        """The fast-path CAS witness for an EXCLUSIVE lease."""
        return (self.token, _enc(0, self.inflated), self.expires_at)


class _KeyState:
    """Per-key lease registers, allocated on the shard's home node.

    ``holder`` and ``fence`` are read/written **only** inside the shard
    ALock's critical section; ``fence`` is the authoritative token allocator,
    which is why writer grant tokens are strictly monotonic unconditionally.

    ``expires`` packs ``(fence_token, reader_count, expires_at)`` and is the
    one register holders may CAS lock-free: the renewal/release fast path,
    shared joins/leaves, and downgrades all operate on this single word.
    Because remote RMW is not atomic against the critical section's writes
    (Table 1), a **zombie's** in-flight rCAS write phase can, in a vanishing
    window, overwrite a concurrent re-grant's write with its stale tuple.
    The CS-only ``fence`` makes that clobber *detectable* (``expires`` token
    ≠ fence) and *unable to affect token allocation*; grant decisions treat
    a clobbered mirror as expired and repair it (``shard.repairs``
    telemetry).  This is the standard lease-system posture: expiry-time
    races cannot be airtight under asynchrony, fencing tokens are what make
    them harmless downstream — and the tokens themselves never regress.

    ``intent`` is the writer drain barrier: a virtual-time deadline written
    only inside the critical section (by a writer blocked on a live reader
    cohort).  The shared fast paths read it and refuse joins/renewals while
    ``now < intent``, so the cohort drains within one TTL; any writer grant
    clears it.  A stale barrier (the writer timed out or was beaten to the
    grant) simply lapses — no cleanup protocol, same posture as the leases
    themselves.

    ``infl`` / ``infl_epoch`` are host-side inflation metadata (like shard
    placement and the client slot ledger — never part of the simulated
    protocol state): the live :class:`~repro_torch.core.InflatedKeyQueue` for an
    inflated key, or ``None``.  The word's mode bit is authoritative; the
    queue object is the advisory FIFO hung off it, discarded wholesale on
    deflation (the epoch counter keeps discarded-queue register names from
    aliasing a later inflation's).
    """

    __slots__ = ("holder", "expires", "fence", "intent", "payload", "infl",
                 "infl_epoch", "infl_ceiling")

    def __init__(self, mem: AsymmetricMemory, node: int, name: str):
        self.holder = mem.alloc(node, f"{name}.holder", _NO_HOLDER)
        self.expires = mem.alloc(node, f"{name}.expires", (0, 0, _FREE_AT))
        self.fence = mem.alloc(node, f"{name}.fence", 0)
        self.intent = mem.alloc(node, f"{name}.intent", _FREE_AT)
        # Optimistic-read payload: ``(publish_token, value)``, written only
        # by ``publish`` (a fenced read+CAS by the live exclusive holder).
        # The token records WHICH writer generation published the value, so
        # a seqlock reader can cross-check the payload against the packed
        # word (payload token > word token ⇒ the word read was stale or
        # clobbered ⇒ retry).  An advisory cache, not protocol state: a
        # takeover re-seeds it empty on the new home (the ledger records
        # leases, not payloads) — readers then see "never published", which
        # is honest, never stale.
        self.payload = mem.alloc(node, f"{name}.payload", (0, None))
        self.infl: Optional[InflatedKeyQueue] = None
        self.infl_epoch = 0
        # Largest word token the current inflation epoch may allocate via
        # direct handoff (== the value the fence register was raised to).
        # Home-shard metadata, maintained under the shard CS.
        self.infl_ceiling = 0


class LockShard:
    """One shard: an ALock guarding the lease metadata of its keys."""

    def __init__(self, mem: AsymmetricMemory, index: int, home_host: int,
                 init_budget: int, name: str):
        self.index = index
        self.home_host = home_host
        self.init_budget = init_budget
        self.alock = ALock(mem, home_host, init_budget, name=f"{name}.s{index}")
        self.keys: Dict[str, _KeyState] = {}
        # Takeover epoch (host-side mirror of the epoch register).  The
        # epoch and forwarding registers live on the shard's rank-order
        # first successor, NOT the home: they must stay reachable after the
        # home dies (the successor bumps the epoch with a LOCAL CAS; the
        # zombie ex-home pays remote and loses the race detectably).  If
        # home and witness die together the shard is unavailable until one
        # recovers — the documented single-failure posture.
        self.epoch = 0
        witness = (home_host + 1) % mem.num_nodes
        self.epoch_reg = mem.alloc(witness, f"{name}.s{index}.epoch", 0)
        self.fwd_reg = mem.alloc(witness, f"{name}.s{index}.fwd", home_host)
        # Meta-level accounting (not part of the simulated protocol).
        self.stats = {LOCAL: OpCounts(), REMOTE: OpCounts()}
        self.mode_stats = {(m, c): OpCounts()
                           for m in LeaseMode for c in (LOCAL, REMOTE)}
        self.grants = 0
        self.rejects = 0
        self.grants_by_mode = {m: 0 for m in LeaseMode}
        self.rejects_by_mode = {m: 0 for m in LeaseMode}
        self.expirations = 0
        self.fast_renews = 0
        self.fast_releases = 0
        self.shared_joins = 0        # fast-path shared grants (no ALock)
        self.shared_renews = 0
        self.shared_releases = 0
        self.shared_remote_grants = 0   # shared grants paid for over the fabric
        self.shared_acquire_rcas = 0    # rCAS posted by remote shared acquires
        self.upgrades = 0
        self.downgrades = 0
        self.intent_blocks = 0       # shared ops refused by a writer barrier
        self.repairs = 0  # clobbered expiry mirrors repaired by a grant
        # Crash-recovery counters (the ledger/reclaim stack).
        self.reclaims = 0            # successful reclaims, any path
        self.reclaim_fast = 0        # exclusive witness-CAS reclaims
        self.reclaim_slow = 0        # exclusive word-probe reclaims
        self.reclaim_shared = 0      # shared cohort-slot re-adoptions
        self.reclaim_rejects = 0     # reclaim refused (expired/fenced out)
        self.orphan_probes = 0       # dangling-intent probes run
        self.orphan_adopts = 0       # probes that adopted a lost grant
        self.reconstructions = 0     # keys audited by reconstruct_shard
        self.reconstruct_resets = 0  # keys whose registers were re-seeded
        # Self-healing failover counters.
        self.takeovers = 0           # epoch-fenced re-homings completed
        self.takeover_refusals = 0   # refused by the partition guard
        self.takeover_aborts = 0     # lost the epoch CAS / dead host revived
        self.epoch_aborts = 0        # grants discarded by the epoch fence
        self.rehomed_keys = 0        # ledgered keys carried to the new home
        # Contention-adaptive inflation counters.
        self.inflations = 0          # words swung into queued (MCS) mode
        self.deflations = 0          # words swung back, orderly or not
        self.queue_enqueues = 0      # split-phase MCS enqueues
        self.queue_grants = 0        # grants issued via the inflated path
        self.queue_handoffs = 0      # inflated releases that passed the queue
        self.queue_bypasses = 0      # stale-queue fallbacks to the word
        # Per-key blocked-attempt tally (satellite: hot-key report).  Guarded
        # by _meta like every other meta counter; keys only ever accumulate —
        # the table's hot_keys() merges and ranks across shards.
        self.key_retries: Dict[str, int] = {}
        # Per-key fabric-trouble tallies: op timeouts and fabric-level retry
        # rounds charged while transacting on the key (the OpCounts deltas
        # the per-class stats already fold in, re-keyed so the hot-key
        # report can show WHERE the fabric pain lands).
        self.key_timeouts: Dict[str, int] = {}
        self.key_fab_retries: Dict[str, int] = {}
        # Overload-protection counters.
        self.sheds = 0               # acquires refused as deadline-infeasible
        self.hedges = 0              # read-only probes that posted a hedge
        self.deadline_exceeded = 0   # ops refused/aborted on caller deadline
        # Optimistic-read (seqlock) counters.
        self.opt_reads = 0           # untorn snapshots returned lease-free
        self.opt_read_retries = 0    # unstable/contended attempts retried
        self.opt_read_fallbacks = 0  # reads degraded to a shared lease
        self.opt_read_fwd = 0        # tombstoned words chased to a new home
        self.publishes = 0           # fenced payload publishes that landed
        # EWMA of observed blocking-acquire time-to-completion (grant or
        # burned deadline), the shedding feasibility signal (updated
        # outside _meta: float store is atomic enough for a heuristic;
        # sim steps are atomic anyway).
        self.svc_time = 0.0
        self._meta = threading.Lock()


class ShardedLockTable:
    """N lock shards spread over the hosts of one asymmetric memory."""

    def __init__(
        self,
        mem: AsymmetricMemory,
        num_shards: Optional[int] = None,
        init_budget: int = 4,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
        name: str = "table",
        fault: Optional[FaultInjector] = None,
        inflation: Optional[InflationPolicy] = None,
        seed: int = 0,
        overload: Optional[OverloadPolicy] = None,
    ):
        self.mem = mem
        self.num_hosts = mem.num_nodes
        self.num_shards = num_shards or 2 * self.num_hosts
        if self.num_shards <= 0:
            raise ValueError("num_shards must be > 0")
        # clock and sleep travel as a pair: the blocking paths compute their
        # deadline on `clock` and back off on `sleep`, so injecting one
        # without the other (the old wall-clock time.sleep next to a fake
        # clock) would stall a poll loop forever — or time out instantly —
        # whenever the two disagree.  The sim engine injects a virtual clock
        # plus a charging sleep; threaded callers get the time module's pair.
        self.clock = clock or time.monotonic
        self.sleep = sleep or time.sleep
        self.name = name
        self.fault = fault
        self.shards = [
            LockShard(mem, s, s % self.num_hosts, init_budget, name)
            for s in range(self.num_shards)
        ]
        # Client-side cohort-slot ledger: pid -> {key: [count, token,
        # horizon]}.  The packed word's reader count is anonymous — a
        # decrement cannot tell WHOSE slot it takes — so the client library
        # must never post one it does not own: a double release (or a renew
        # / release after an upgrade consumed the slot) would otherwise
        # free another live reader's slot and let a writer in beside them.
        # Within one process, slots of the same (key, generation) are
        # fungible: a stale handle releases one of the CALLER'S own slots
        # (self-inflicted, contained) — it can never free another client's.
        # A pid is single-threaded by the spawn contract, so each inner
        # per-pid dict is accessed (and swept, amortised) lock-free by its
        # owner; the guard covers only outer-dict insertion.  Entries die
        # with their horizon, like the service lease cache.
        self._slots: Dict[int, Dict[str, List]] = {}
        self._slots_guard = threading.Lock()
        # Contention-adaptive inflation (None = feature off: one attribute
        # check per exclusive acquire, nothing else — zero cost when idle).
        self.inflation = inflation
        self._estimator = (ContentionEstimator(inflation)
                           if inflation is not None else None)
        self._init_budget = init_budget
        # Inflate/deflate event log: [t, action, key, token, reason] rows,
        # appended in decision order.  Decisions are pure functions of the
        # seeded event sequence + virtual clock, so two same-seed sim runs
        # produce byte-identical logs (a CI determinism gate diffs them).
        self._infl_events: List[List] = []
        self._infl_guard = threading.Lock()
        # Blocking-acquire backoff RNG: seeded so the sim's sleep schedule
        # (hence every downstream decision) is a function of the seed.
        self._rng = random.Random(seed)
        # Overload protection (None = feature off: every gate below is one
        # attribute check, nothing else — the legacy cost shape is intact).
        self.overload = (OverloadControl(overload, seed)
                         if overload is not None else None)
        # Client-side queue-wait ledger, the inflated-mode sibling of
        # ``_slots``: pid -> {key: [queue, last_progress_at, holding]}.
        # Same access contract (a pid is single-threaded, the guard covers
        # only outer-dict insertion).  An entry whose queue is no longer the
        # key's installed one belongs to a discarded epoch and is dropped.
        self._waits: Dict[int, Dict[str, List]] = {}
        self._waits_guard = threading.Lock()
        # Registered async pipelines: pid -> AsyncClient.  A hedged
        # probe by a process that drives a pipeline rides that pipeline's
        # next flush for the probed host instead of posting its own
        # doorbell (see _probe/_hedged_read).  Host-side metadata only.
        self._pipelines: Dict[int, object] = {}

    _SLOTS_SWEEP = 1024

    def _pid_slots(self, p: Process) -> Dict[str, List]:
        slots = self._slots.get(p.pid)
        if slots is None:
            with self._slots_guard:
                slots = self._slots.setdefault(p.pid, {})
        return slots

    def _pid_waits(self, p: Process) -> Dict[str, List]:
        waits = self._waits.get(p.pid)
        if waits is None:
            with self._waits_guard:
                waits = self._waits.setdefault(p.pid, {})
        return waits

    def _log_infl_event(self, now: float, action: str, key: str,
                        token: int, reason: str) -> None:
        with self._infl_guard:
            self._infl_events.append(
                [round(now, 9), action, key, token, reason])

    def _slot_join(self, p: Process, key: str, token: int,
                   horizon: float) -> None:
        """Record one cohort slot owned by ``p`` on ``key``."""
        slots = self._pid_slots(p)
        if len(slots) >= self._SLOTS_SWEEP:
            now = self.clock()
            for k in [k for k, e in slots.items()
                      if e[0] <= 0 or now >= e[2]]:
                del slots[k]
        entry = slots.get(key)
        if (entry is not None and entry[1] == token
                and self.clock() < entry[2]):
            entry[0] += 1
            entry[2] = max(entry[2], horizon)
        else:
            slots[key] = [1, token, horizon]

    def _slot_count(self, p: Process, key: str, token: int) -> int:
        """How many slots of ``key``'s generation ``token`` does ``p`` own?"""
        entry = self._pid_slots(p).get(key)
        return entry[0] if entry is not None and entry[1] == token else 0

    def _slot_owned(self, p: Process, key: str, token: int) -> bool:
        return self._slot_count(p, key, token) > 0

    def _slot_extend(self, p: Process, key: str, token: int,
                     horizon: float) -> None:
        entry = self._pid_slots(p).get(key)
        if entry is not None and entry[1] == token:
            entry[2] = max(entry[2], horizon)

    def _slot_consume(self, p: Process, key: str, token: int) -> None:
        entry = self._pid_slots(p).get(key)
        if entry is not None and entry[1] == token and entry[0] > 0:
            entry[0] -= 1

    # ---------------------------------------------------------- placement
    def shard_of(self, key: str) -> int:
        """Stable hash placement: same key → same shard, in every process."""
        return stable_key_hash(key) % self.num_shards

    def home_of(self, key: str) -> int:
        """The host that is the zero-RDMA local class for ``key``."""
        return self.shards[self.shard_of(key)].home_host

    def _key_state(self, shard: LockShard, key: str) -> _KeyState:
        st = shard.keys.get(key)
        if st is None:
            with shard._meta:
                st = shard.keys.get(key)
                if st is None:
                    st = _KeyState(
                        self.mem, shard.home_host,
                        self._key_state_name(shard, key),
                    )
                    shard.keys[key] = st
        return st

    def _key_state_name(self, shard: LockShard, key: str) -> str:
        # Register names are globally unique (mem.alloc raises on reuse), so
        # post-takeover allocations carry the shard epoch: the dead home's
        # registers keep their epoch-0 names, the rebuilt ones never alias.
        suffix = f".e{shard.epoch}" if shard.epoch else ""
        return (f"{self.name}.s{shard.index}"
                f".k{stable_key_hash(key):016x}{suffix}")

    # ------------------------------------------------------ fault injection
    def _crash_point(self, label: str, p: Process) -> None:
        """A labeled crash window (see ``repro_torch.coord.faults``).  Every call
        site sits OUTSIDE the shard ALock's critical section: a holder may
        die at any of them and the shard stays serviceable — leases expire
        (or are reclaimed), the CS is never wedged."""
        if self.fault is not None:
            self.fault.crash_point(label, p.pid)

    # ------------------------------------------------- overload primitives
    def _deadline_gate(self, op: str, key: str, shard: LockShard,
                       deadline: Optional[float]) -> None:
        """Fail fast — zero fabric ops — when the caller's budget is gone.

        Every public op takes an optional absolute ``deadline``; an op
        entered past it refuses with the typed :class:`~repro_torch.core.
        DeadlineExceeded` instead of posting doomed work at a (possibly
        congested) home host.
        """
        if deadline is not None and self.clock() >= deadline:
            with shard._meta:
                shard.deadline_exceeded += 1
            raise DeadlineExceeded(f"{op} of {key!r}: deadline passed")

    def _probe(self, p: Process, reg,
               shard: Optional[LockShard] = None):
        """A read-only liveness probe, hedged under overload control.

        Without a policy (or for a local register) this is exactly
        ``mem.probe``.  With one, the observed latency feeds the
        destination's p99 tracker, and a probe that timed out after the
        tracked threshold may be re-posted ONCE — first response wins —
        provided the destination's retry budget admits the hedge (hedges
        are speculative retry traffic and are capped by the same bucket).
        """
        ctl = self.overload
        host = reg.node
        if ctl is None or p.node == host:
            return self.mem.probe(p, reg)
        t0 = self.clock()
        out = self.mem.probe(p, reg)
        dt = self.clock() - t0
        ctl.observe_latency(host, dt)
        if (out is TIMEOUT and dt >= ctl.hedge_threshold(host)
                and ctl.allow_hedge(host)):
            # The hedge itself is admitted by the same retry budget as
            # before; only its TRANSPORT changes when the caller drives an
            # async pipeline — the re-post then rides the pipeline's flush
            # for this host (sharing a doorbell with any queued work)
            # instead of posting its own.  Idempotent read, so riding a
            # mixed WR list is safe.
            pl = self._pipelines.get(p.pid)
            if pl is not None:
                try:
                    out = pl.ride_read(reg)
                except RemoteTimeout:
                    out = TIMEOUT
            else:
                out = self.mem.probe(p, reg)
            ctl.observe_latency(host, self.clock() - t0)
            if shard is not None:
                with shard._meta:
                    shard.hedges += 1
        return out

    def _hedged_read(self, p: Process, reg,
                     shard: Optional[LockShard] = None):
        """``auto_read`` whose terminal RemoteTimeout may hedge one re-post.

        The reclaim word-probe rides this: a restarted client racing its
        TTL must not die on one exhausted gate when the budget still admits
        a speculative second posting.
        """
        ctl = self.overload
        host = reg.node
        if ctl is None or p.node == host:
            return self.mem.auto_read(p, reg)
        t0 = self.clock()
        try:
            val = self.mem.auto_read(p, reg)
        except RemoteTimeout:
            ctl.observe_latency(host, self.clock() - t0)
            if not ctl.allow_hedge(host):
                raise
            if shard is not None:
                with shard._meta:
                    shard.hedges += 1
            # Same budget, cheaper transport: a pipeline-driving caller's
            # hedge rides the pipeline flush for this host (idempotent
            # read in a shared WR list) instead of a dedicated doorbell.
            pl = self._pipelines.get(p.pid)
            val = (pl.ride_read(reg) if pl is not None
                   else self.mem.auto_read(p, reg))
        ctl.observe_latency(host, self.clock() - t0)
        return val

    # ---------------------------------------------------------- accounting
    def _account(self, shard: LockShard, p: Process, snap: tuple,
                 mode: LeaseMode) -> None:
        cls = LOCAL if p.node == shard.home_host else REMOTE
        with shard._meta:
            shard.stats[cls].add_since(p.counts, snap)
            shard.mode_stats[(mode, cls)].add_since(p.counts, snap)

    # --------------------------------------------------- batched register IO
    def _read_pairs(self, p: Process, shard: LockShard,
                    states: Sequence[_KeyState]) -> List[Tuple[tuple, int]]:
        """Read each key's (expires, fence) — one doorbell for remote clients."""
        if p.node == shard.home_host:
            return [
                (self.mem.read(p, st.expires), self.mem.read(p, st.fence))
                for st in states
            ]
        flat = self.mem.post_batch(
            p,
            [wr for st in states
             for wr in (("read", st.expires), ("read", st.fence))],
        )
        return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(states))]

    def _read_key_state(self, p: Process, shard: LockShard,
                        st: _KeyState) -> Tuple[int, tuple, int, float]:
        """The slow paths' validation read set (holder, expires, fence,
        intent) — one doorbell for remote clients."""
        if p.node == shard.home_host:
            return (self.mem.read(p, st.holder),
                    self.mem.read(p, st.expires),
                    self.mem.read(p, st.fence),
                    self.mem.read(p, st.intent))
        holder, packed, fence, barrier = self.mem.post_batch(p, [
            ("read", st.holder), ("read", st.expires),
            ("read", st.fence), ("read", st.intent),
        ])
        return holder, packed, fence, barrier

    def _shared_read(self, p: Process, shard: LockShard,
                     st: _KeyState) -> Tuple[tuple, int, float]:
        """The shared fast path's read set (expires, fence, intent) — one
        doorbell for remote clients, three machine reads for local ones."""
        if p.node == shard.home_host:
            return (self.mem.read(p, st.expires),
                    self.mem.read(p, st.fence),
                    self.mem.read(p, st.intent))
        packed, fence, barrier = self.mem.post_batch(p, [
            ("read", st.expires), ("read", st.fence), ("read", st.intent),
        ])
        return packed, fence, barrier

    # ------------------------------------------------------- shared fast path
    def _shared_acquire(self, p: Process, shard: LockShard, key: str,
                        ttl: float) -> Optional[Lease]:
        """Grant a SHARED lease with a single CAS on the packed word.

        Joinable states: free, expired (any mode), or a live reader cohort.
        A live writer blocks; an armed writer-intent barrier blocks (drain
        priority); a clobbered mirror (word token ≠ fence) is repaired via
        the critical section like any grant over untrusted state.  The CAS
        either joins the live cohort (count+1, expiry extended to cover this
        reader) or opens a fresh generation (count=1) reusing the last
        CS-allocated token — token allocation stays CS-only, so writer
        tokens remain strictly monotonic and are always strictly larger
        than any reader generation they displace.
        """
        st = self._key_state(shard, key)
        snap = p.counts.as_tuple()
        local = p.node == shard.home_host
        lease: Optional[Lease] = None
        intent_block = False
        repair = False
        expired_over = False
        rcas_posted = 0
        try:
            for _ in range(_FAST_ATTEMPTS):
                now = self.clock()
                packed, fence, barrier = self._shared_read(p, shard, st)
                etok, readers, eexp = packed
                if now < barrier:
                    intent_block = True  # a writer is draining this key
                    break
                if not _trusted(etok, fence, readers):
                    repair = True  # untrusted mirror: go repair via the CS
                    break
                dec, infl = _dec(readers), _infl(readers)
                free = eexp <= _FREE_AT
                live = (not free) and now < eexp
                if live and dec == 0:
                    break  # a live writer holds the key
                if live:  # join the live reader cohort (either mode)
                    new = (etok, _enc(dec + 1, infl), max(eexp, now + ttl))
                else:     # open a fresh generation over free/expired state
                    new = (etok, _enc(1, infl), now + ttl)
                observed = self.mem.auto_cas(p, st.expires, packed, new)
                if not local:
                    rcas_posted += 1
                if observed == packed:
                    lease = Lease(key, shard.index, p.pid, etok, now + ttl,
                                  ttl, LeaseMode.SHARED, infl)
                    expired_over = (not free) and not live
                    break
                self.mem.yield_point()  # lost to another shared CAS: retry
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        if repair:
            return self._shared_repair_grant(p, shard, key, st, ttl,
                                             rcas_posted)
        if lease is not None:
            self._slot_join(p, key, lease.token, lease.expires_at)
        with shard._meta:
            shard.shared_acquire_rcas += rcas_posted
            if lease is not None:
                shard.grants += 1
                shard.grants_by_mode[LeaseMode.SHARED] += 1
                shard.shared_joins += 1
                if not local:
                    shard.shared_remote_grants += 1
                if expired_over:
                    shard.expirations += 1
            else:
                shard.rejects += 1
                shard.rejects_by_mode[LeaseMode.SHARED] += 1
                if intent_block:
                    shard.intent_blocks += 1
        return lease

    def _shared_repair_grant(self, p: Process, shard: LockShard, key: str,
                             st: _KeyState, ttl: float,
                             rcas_posted: int) -> Optional[Lease]:
        """A shared grant over a clobbered mirror: the one shared-acquire
        case that must run under the shard ALock (the mirror cannot be
        trusted, so the CS re-validates and re-seeds it — allocating a fresh
        token, exactly like an exclusive grant over untrusted state)."""
        snap = p.counts.as_tuple()
        lease: Optional[Lease] = None
        repaired = False
        blocked_by_intent = False
        try:
            now = self.clock()
            alock = shard.alock  # pin: a takeover swaps shard.alock mid-CS
            alock.lock(p)
            writes: List[tuple] = []
            try:
                holder, packed, fence, barrier = \
                    self._read_key_state(p, shard, st)
                etok, readers, eexp = packed
                if now < barrier:
                    blocked_by_intent = True
                else:
                    free = eexp <= _FREE_AT
                    clobbered = not _trusted(etok, fence, readers)
                    if free or clobbered or now >= eexp:
                        token = fence + 1
                        # CAS, not write: a CS-free join can land between
                        # the read above and this commit; the CAS loses
                        # cleanly and the caller's retry re-reads.
                        if self.mem.auto_cas(p, st.expires, packed,
                                             (token, 1, now + ttl)) == packed:
                            lease = Lease(key, shard.index, p.pid, token,
                                          now + ttl, ttl, LeaseMode.SHARED)
                            writes = [
                                ("write", st.fence, token),
                                ("write", st.holder, _NO_HOLDER),
                                ("write", st.intent, _FREE_AT),
                            ]
                            repaired = clobbered
                            # A repair grant re-seeds the word DEFLATED
                            # (the state was untrusted — disorderly events
                            # always reset queue state rather than trust it).
                            if st.infl is not None:
                                st.infl = None
                                self._estimator.mark_deflated(key, now)
                                self._log_infl_event(now, "deflate", key,
                                                     token, "repair")
                                with shard._meta:
                                    shard.deflations += 1
                    # else: someone re-granted cleanly while we queued for
                    # the CS — report a reject; the caller's retry will join.
            finally:
                alock.unlock(p, piggyback=writes or None)
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        if lease is not None:
            self._slot_join(p, key, lease.token, lease.expires_at)
        with shard._meta:
            shard.shared_acquire_rcas += rcas_posted
            if lease is not None:
                shard.grants += 1
                shard.grants_by_mode[LeaseMode.SHARED] += 1
                if p.node != shard.home_host:
                    shard.shared_remote_grants += 1
                if repaired:
                    shard.repairs += 1
            else:
                shard.rejects += 1
                shard.rejects_by_mode[LeaseMode.SHARED] += 1
                if blocked_by_intent:
                    shard.intent_blocks += 1
        return lease

    # --------------------------------------------------------------- leases
    def _acquire_group(self, p: Process, shard: LockShard,
                       keys: Sequence[str], ttl: float,
                       mode: LeaseMode = LeaseMode.EXCLUSIVE,
                       ) -> Tuple[List[Lease], bool]:
        """Grant a prefix of ``keys`` (one shard, global order).

        EXCLUSIVE mode runs the original transaction in **one** ALock
        critical section; SHARED mode joins each key's reader cohort with
        the CS-free single-CAS fast path (shared grants never conflict with
        each other, so there is no critical section to batch).

        Returns ``(granted, blocked)``: the leases granted, and whether the
        next key was held by a live lease (granting stops there — taking
        later keys while a smaller one is still wanted would break the
        deadlock-avoidance total order).  Never blocks inside the critical
        section.
        """
        if mode == LeaseMode.SHARED:
            granted: List[Lease] = []
            for key in keys:
                lease = self._shared_acquire(p, shard, key, ttl)
                if lease is None:
                    return granted, True
                granted.append(lease)
            return granted, False

        states = [self._key_state(shard, k) for k in keys]
        snap = p.counts.as_tuple()
        local = p.node == shard.home_host
        granted = []
        writes: List[tuple] = []
        blocked = False
        blocked_key: Optional[str] = None
        inflated_key: Optional[Tuple[str, int]] = None
        armed_drain = False
        expirations = 0
        repairs = 0
        # Sample the clock BEFORE acquiring: every register read then happens
        # at-or-after ``now``, so an "expired" verdict (eexp <= now <= read
        # time) can only be beaten by a renewal whose local-clock check
        # predates ``now`` but whose CAS lands after our read — i.e. exactly
        # the documented zombie window.  Sampling after the lock would let a
        # *healthy* pre-expiry renewal race the piggybacked (pre-CS) reads
        # and be silently re-granted over.
        now = self.clock()
        alock = shard.alock  # pin: a takeover swaps shard.alock mid-CS
        try:
            if local:
                alock.lock(p)
                flat = None
            else:
                # Chain the lease-register reads into the Peterson-engagement
                # doorbell; valid on uncontended fast entry, else re-read.
                flat = alock.lock(p, piggyback_reads=[
                    r for st in states for r in (st.expires, st.fence)
                ])
            try:
                if flat is None:
                    vals = self._read_pairs(p, shard, states)
                else:
                    vals = [(flat[2 * i], flat[2 * i + 1])
                            for i in range(len(states))]
                # Verdict pass: the grantable prefix in global order.
                plan = []  # (key, st, packed, new token, clobbered, free, enc0)
                for key, st, ((etok, readers, eexp), fence) in zip(
                        keys, states, vals):
                    free = eexp <= _FREE_AT
                    # Untrusted mirror: a zombie CAS hit it, or the word is
                    # freshly deflated under a still-raised epoch ceiling.
                    clobbered = not _trusted(etok, fence, readers)
                    if not free and not clobbered and now < eexp:
                        blocked = True
                        blocked_key = key
                        if _dec(readers) > 0:
                            # A live reader cohort: arm the drain barrier so
                            # no new reader joins (and no shared renewal
                            # extends the cohort) past its current horizon —
                            # the writer's wait is bounded by one TTL.
                            writes.append(("write", st.intent, eexp))
                            armed_drain = True
                        elif (self._estimator is not None
                                and not _infl(readers)):
                            # Blocked on a live writer-held deflated word:
                            # the contention signal the estimator feeds on.
                            self._estimator.note(key, now)
                            if (st.infl is None
                                    and self._estimator.should_inflate(
                                        key, now)):
                                # Install the queue BEFORE the mode CAS: a
                                # concurrent step must never observe an
                                # inflated word with no queue behind it.
                                st.infl_epoch += 1
                                st.infl = InflatedKeyQueue(
                                    self.mem, shard.home_host,
                                    self._init_budget,
                                    f"{self.name}.s{shard.index}"
                                    f".k{stable_key_hash(key):016x}"
                                    f".iq{st.infl_epoch}")
                                # One CAS swings the mode: token and expiry
                                # untouched, readers 0 -> -1 (inflated, no
                                # readers).  Losing (to the holder's renew /
                                # release CAS) reverts cleanly — the next
                                # blocked attempt re-decides.
                                if self.mem.auto_cas(
                                    p, st.expires, (etok, readers, eexp),
                                    (etok, _enc(0, True), eexp),
                                ) == (etok, readers, eexp):
                                    self._estimator.mark_inflated(key, now)
                                    inflated_key = (key, etok)
                                    # No token-block reservation yet: the
                                    # pre-inflation holder's lease still
                                    # witnesses ``fence == token``, and
                                    # raising the fence here would strand
                                    # its release until TTL expiry.  The
                                    # ceiling stays at the current token
                                    # (zero direct-handoff headroom) until
                                    # the FIRST critical-section grant on
                                    # the inflated key reserves the block.
                                    st.infl_ceiling = etok
                                else:
                                    st.infl = None
                        break
                    if st.infl is not None and not st.infl.empty(p):
                        # FIFO discipline: an inflated key's grant order is
                        # owned by its queue — a CS transaction must not
                        # jump live waiters (the inflated acquire path is
                        # the only granting entry while the queue is
                        # populated).
                        blocked = True
                        blocked_key = key
                        break
                    token = fence + 1  # CS-only allocator: never regresses
                    plan.append((key, st, (etok, readers, eexp), token,
                                 clobbered, free,
                                 _enc(0, st.infl is not None)))
                # Commit pass: every packed-word mutation is a CAS against
                # the value this transaction read — the CS excludes other
                # critical sections but NOT the CS-free shared joins, so a
                # plain grant write could stomp a reader that joined the
                # free word in the decision window.  The CAS loses instead
                # (and the key reports blocked).  Remote clients post the
                # whole group's grant CASes in one doorbell.
                if plan:
                    if local:
                        won = [
                            self.mem.cas(p, st.expires, packed,
                                         (token, enc0, now + ttl)) == packed
                            for (_k, st, packed, token, _c, _f, enc0) in plan
                        ]
                    else:
                        obs = self.mem.post_batch(p, [
                            ("cas", st.expires, packed,
                             (token, enc0, now + ttl))
                            for (_k, st, packed, token, _c, _f, enc0) in plan
                        ])
                        won = [o == packed
                               for o, (_k, _s, packed, *_r) in zip(obs, plan)]
                    cut = won.index(False) if False in won else len(plan)
                    # Global-order discipline: nothing may be held past the
                    # first loser.  The batch's CASes already executed, so
                    # un-grant any stray winners after the cut (we hold the
                    # only witness to the value we just wrote; only the
                    # vanishing remote-window can beat the rollback, and a
                    # clobbered word is repaired by the next grant).
                    rollback = [
                        ("cas", st.expires, (token, enc0, now + ttl), packed)
                        for i, (_k, st, packed, token, _c, _f, enc0)
                        in enumerate(plan)
                        if i > cut and won[i]
                    ]
                    if rollback:
                        if local:
                            for _op, reg, exp_v, new_v in rollback:
                                self.mem.cas(p, reg, exp_v, new_v)
                        else:
                            self.mem.post_batch(p, rollback)
                    if cut < len(plan):
                        blocked = True
                        blocked_key = plan[cut][0]
                    for (key, st, packed, token, clobbered, free,
                         enc0) in plan[:cut]:
                        if clobbered:
                            repairs += 1  # untrusted mirror: repaired
                        elif not free:
                            expirations += 1  # grant over an expired lease
                        granted.append(
                            Lease(key, shard.index, p.pid, token, now + ttl,
                                  ttl, LeaseMode.EXCLUSIVE, _infl(enc0))
                        )
                        fence_val = token
                        if _infl(enc0):
                            # A CS grant on a still-inflated key re-reserves
                            # the direct-handoff token block above it.
                            st.infl_ceiling = fence_val = token + _INFL_RESERVE
                        writes += [
                            ("write", st.fence, fence_val),
                            ("write", st.holder, p.pid),
                            ("write", st.intent, _FREE_AT),  # barrier served
                        ]
            finally:
                # The grant writes ride the unlock: applied in place by a
                # local releaser, chained into the tail-drain doorbell by a
                # remote one — still inside the critical section either way.
                alock.unlock(p, piggyback=writes or None)
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
        with shard._meta:
            shard.grants += len(granted)
            shard.grants_by_mode[LeaseMode.EXCLUSIVE] += len(granted)
            shard.expirations += expirations
            shard.repairs += repairs
            if inflated_key is not None:
                shard.inflations += 1
            if blocked:
                shard.rejects += 1
                shard.rejects_by_mode[LeaseMode.EXCLUSIVE] += 1
                if blocked_key is not None:
                    shard.key_retries[blocked_key] = \
                        shard.key_retries.get(blocked_key, 0) + 1
        if inflated_key is not None:
            self._log_infl_event(now, "inflate", inflated_key[0],
                                 inflated_key[1], "hot")
            # The inflater is a (blocked) waiter, not a holder: its death
            # here leaves a freshly inflated key whose queue it never
            # joined — the key serves normally through the inflated path
            # and deflates when cool.
            self._crash_point("inflate.mid", p)
        if armed_drain:
            # The writer just armed a reader-cohort drain barrier and is
            # about to wait outside the CS — the window where its death
            # abandons the barrier (which lapses on its own: it is a
            # deadline, not a lock).
            self._crash_point("drain.mid", p)
        return granted, blocked

    def _unlock_run(self, p: Process, locked: List[ALock],
                    writes: List[tuple]) -> None:
        """Unlock a run's ALocks; all piggybacked writes ride the FIRST
        unlock's doorbell — every group's critical section is still held
        when that posting executes, so each write stays CS-protected by
        its own shard's lock.  Nested finallys: a fabric failure in one
        unlock never strands the rest."""
        if not locked:
            return
        try:
            locked[0].unlock(p, piggyback=writes or None)
        finally:
            self._unlock_run(p, locked[1:], [])

    def _acquire_run(self, p: Process,
                     groups: Sequence[Tuple[LockShard, Sequence[str]]],
                     ttl: float) -> Tuple[List[Lease], bool]:
        """EXCLUSIVE grant pass over a *run* of shard groups sharing one
        home host — ``_acquire_group`` generalised so the cross-group WR
        lists merge into one posting per destination (satellite: the
        batch/shards16 3.55-doorbells/op fix).

        The run's ALocks are taken in ascending shard order (the global
        total order — every locker ascends, so no cycle of CS waiters can
        form), each engagement piggybacking its own group's lease-register
        reads; failed piggybacks re-read in ONE merged posting; the grant
        CASes of *all* groups commit in ONE posting (WR lists execute in
        order, preserving the key order inside the doorbell); the fence/
        holder/intent writes all ride the first unlock while every CS is
        still held.  Per-group doorbells drop from 3 (engage, commit,
        unlock) to 2 + 1/k.  Verdict logic, inflation decisions, and the
        stop-at-first-blocked discipline are exactly ``_acquire_group``'s,
        applied over the run's flat key order.
        """
        first_shard = groups[0][0]
        local = p.node == first_shard.home_host
        snap = p.counts.as_tuple()
        granted: List[Lease] = []
        writes: List[tuple] = []
        blocked = False
        blocked_at: Optional[Tuple[LockShard, str]] = None
        inflated_at: Optional[Tuple[LockShard, str, int]] = None
        armed_drain = False
        expirations: Dict[int, int] = {}
        repairs: Dict[int, int] = {}
        # Clock sampled before any lock, same zombie-window argument as
        # _acquire_group (see there).
        now = self.clock()
        locked: List[ALock] = []
        ctx: List[Tuple[LockShard, Sequence[str], List[_KeyState],
                        Optional[list]]] = []
        try:
            try:
                for shard, keys in groups:
                    states = [self._key_state(shard, k) for k in keys]
                    alock = shard.alock  # pin: takeover swaps it mid-CS
                    if local:
                        alock.lock(p)
                        flat = None
                    else:
                        flat = alock.lock(p, piggyback_reads=[
                            r for st in states
                            for r in (st.expires, st.fence)
                        ])
                    locked.append(alock)
                    ctx.append((shard, keys, states, flat))
                # Re-read every group whose piggyback went unvalidated —
                # ONE merged posting for the whole run (every register
                # lives on the run's single home node).
                need = [(gi, c[2]) for gi, c in enumerate(ctx)
                        if c[3] is None]
                reread: Dict[int, List[Tuple[tuple, int]]] = {}
                if need:
                    if local:
                        for gi, states in need:
                            reread[gi] = [
                                (self.mem.read(p, st.expires),
                                 self.mem.read(p, st.fence))
                                for st in states]
                    else:
                        flatv = self.mem.post_batch(p, [
                            wr for _gi, states in need for st in states
                            for wr in (("read", st.expires),
                                       ("read", st.fence))])
                        off = 0
                        for gi, states in need:
                            reread[gi] = [
                                (flatv[off + 2 * i], flatv[off + 2 * i + 1])
                                for i in range(len(states))]
                            off += 2 * len(states)
                # Verdict pass over the run's flat key order; stops at the
                # first blocked key (global-order discipline: nothing past
                # it may be planned, in THIS group or any later one).
                plan = []  # (shard, key, st, packed, token, clob, free, enc0)
                for gi, (shard, keys, states, flat) in enumerate(ctx):
                    if blocked:
                        break
                    if flat is not None:
                        vals = [(flat[2 * i], flat[2 * i + 1])
                                for i in range(len(states))]
                    else:
                        vals = reread[gi]
                    for key, st, ((etok, readers, eexp), fence) in zip(
                            keys, states, vals):
                        free = eexp <= _FREE_AT
                        clobbered = not _trusted(etok, fence, readers)
                        if not free and not clobbered and now < eexp:
                            blocked = True
                            blocked_at = (shard, key)
                            if _dec(readers) > 0:
                                writes.append(("write", st.intent, eexp))
                                armed_drain = True
                            elif (self._estimator is not None
                                    and not _infl(readers)):
                                self._estimator.note(key, now)
                                if (st.infl is None
                                        and self._estimator.should_inflate(
                                            key, now)):
                                    st.infl_epoch += 1
                                    st.infl = InflatedKeyQueue(
                                        self.mem, shard.home_host,
                                        self._init_budget,
                                        f"{self.name}.s{shard.index}"
                                        f".k{stable_key_hash(key):016x}"
                                        f".iq{st.infl_epoch}")
                                    if self.mem.auto_cas(
                                        p, st.expires, (etok, readers, eexp),
                                        (etok, _enc(0, True), eexp),
                                    ) == (etok, readers, eexp):
                                        self._estimator.mark_inflated(key, now)
                                        inflated_at = (shard, key, etok)
                                        st.infl_ceiling = etok
                                    else:
                                        st.infl = None
                            break
                        if st.infl is not None and not st.infl.empty(p):
                            blocked = True
                            blocked_at = (shard, key)
                            break
                        token = fence + 1  # CS-only allocator
                        plan.append((shard, key, st, (etok, readers, eexp),
                                     token, clobbered, free,
                                     _enc(0, st.infl is not None)))
                # Commit pass: ONE posting of every group's grant CASes
                # (same CAS-against-read discipline as _acquire_group; WR
                # entries execute in list order, so grants land in the
                # global key order even inside the merged doorbell).
                if plan:
                    if local:
                        won = [
                            self.mem.cas(p, st.expires, packed,
                                         (token, enc0, now + ttl)) == packed
                            for (_sh, _k, st, packed, token, _c, _f, enc0)
                            in plan
                        ]
                    else:
                        obs = self.mem.post_batch(p, [
                            ("cas", st.expires, packed,
                             (token, enc0, now + ttl))
                            for (_sh, _k, st, packed, token, _c, _f, enc0)
                            in plan
                        ])
                        won = [o == packed
                               for o, (_sh, _k, _s, packed, *_r)
                               in zip(obs, plan)]
                    cut = won.index(False) if False in won else len(plan)
                    rollback = [
                        ("cas", st.expires, (token, enc0, now + ttl), packed)
                        for i, (_sh, _k, st, packed, token, _c, _f, enc0)
                        in enumerate(plan)
                        if i > cut and won[i]
                    ]
                    if rollback:
                        if local:
                            for _op, reg, exp_v, new_v in rollback:
                                self.mem.cas(p, reg, exp_v, new_v)
                        else:
                            self.mem.post_batch(p, rollback)
                    if cut < len(plan):
                        blocked = True
                        blocked_at = (plan[cut][0], plan[cut][1])
                    for (shard, key, st, packed, token, clobbered, free,
                         enc0) in plan[:cut]:
                        if clobbered:
                            repairs[shard.index] = \
                                repairs.get(shard.index, 0) + 1
                        elif not free:
                            expirations[shard.index] = \
                                expirations.get(shard.index, 0) + 1
                        granted.append(
                            Lease(key, shard.index, p.pid, token, now + ttl,
                                  ttl, LeaseMode.EXCLUSIVE, _infl(enc0))
                        )
                        fence_val = token
                        if _infl(enc0):
                            st.infl_ceiling = fence_val = \
                                token + _INFL_RESERVE
                        writes += [
                            ("write", st.fence, fence_val),
                            ("write", st.holder, p.pid),
                            ("write", st.intent, _FREE_AT),
                        ]
            finally:
                self._unlock_run(p, locked, writes)
        finally:
            # Merged-posting accounting lands on the run's first shard
            # (the per-class split is identical — one home, one class).
            self._account(first_shard, p, snap, LeaseMode.EXCLUSIVE)
        ngrant: Dict[int, int] = {}
        for g in granted:
            ngrant[g.shard] = ngrant.get(g.shard, 0) + 1
        for shard, _keys in groups:
            si = shard.index
            if not (si in ngrant or si in expirations or si in repairs
                    or (blocked_at is not None
                        and blocked_at[0].index == si)
                    or (inflated_at is not None
                        and inflated_at[0].index == si)):
                continue
            with shard._meta:
                shard.grants += ngrant.get(si, 0)
                shard.grants_by_mode[LeaseMode.EXCLUSIVE] += ngrant.get(si, 0)
                shard.expirations += expirations.get(si, 0)
                shard.repairs += repairs.get(si, 0)
                if inflated_at is not None and inflated_at[0].index == si:
                    shard.inflations += 1
                if blocked_at is not None and blocked_at[0].index == si:
                    shard.rejects += 1
                    shard.rejects_by_mode[LeaseMode.EXCLUSIVE] += 1
                    shard.key_retries[blocked_at[1]] = \
                        shard.key_retries.get(blocked_at[1], 0) + 1
        if inflated_at is not None:
            self._log_infl_event(now, "inflate", inflated_at[1],
                                 inflated_at[2], "hot")
            self._crash_point("inflate.mid", p)
        if armed_drain:
            self._crash_point("drain.mid", p)
        return granted, blocked

    def try_acquire(self, p: Process, key: str, ttl: float,
                    mode: LeaseMode = LeaseMode.EXCLUSIVE) -> Optional[Lease]:
        """One lease-table transaction; non-blocking.

        EXCLUSIVE: grants iff the key is free or its current lease (either
        mode) has expired; a fresh grant always carries a larger fencing
        token.  Returns ``None`` while a live lease exists — *including* the
        caller's own (non-reentrant: a holder extends via :meth:`renew`;
        silently superseding would let one process posing as several clients
        steal its own slots).

        SHARED: grants iff the key is free, expired, or held by a live
        reader cohort with no writer draining it — a single CAS (per
        attempt; a lost race with another shared CAS retries, bounded by
        ``_FAST_ATTEMPTS``), no shard ALock.  Shared joins by the same
        process stack (each join holds one cohort slot and needs its own
        release); a live writer or an armed writer-intent barrier yields
        ``None``.

        When the table carries an :class:`~repro_torch.coord.OverloadPolicy`, a
        remote attempt is gated by the destination host's circuit breaker
        (an open breaker raises :class:`~repro_torch.core.Overloaded` *before*
        any fabric op is posted — the fast-refusal path), and the attempt's
        outcome (RemoteTimeout, or op timeouts absorbed by the fabric's
        internal retries, count as failure) feeds the breaker window and
        refills the retry budget on success.
        """
        if ttl <= 0:
            raise ValueError("ttl must be > 0")
        shard = self.shards[self.shard_of(key)]
        home = shard.home_host
        ctl = self.overload
        gated = ctl is not None and p.node != home
        if gated:
            ctl.admit_remote(home, self.clock())
        t0, r0 = p.counts.timeouts, p.counts.retries
        epoch0 = shard.epoch
        ok = True
        try:
            if mode == LeaseMode.SHARED:
                lease = self._shared_acquire(p, shard, key, ttl)
            elif (self.inflation is not None
                    and (st := shard.keys.get(key)) is not None
                    and st.infl is not None):
                lease = self._inflated_acquire(p, shard, key, st, ttl)
            else:
                granted, _ = self._acquire_group(p, shard, (key,), ttl, mode)
                lease = granted[0] if granted else None
        except RemoteTimeout:
            ok = False
            raise
        finally:
            dt_t = p.counts.timeouts - t0
            dt_r = p.counts.retries - r0
            if dt_t or dt_r:
                # Satellite: the fabric already counts op timeouts and
                # retry rounds in OpCounts, but nothing said WHERE they
                # landed — re-key the deltas so hot_keys() can report them.
                with shard._meta:
                    if dt_t:
                        shard.key_timeouts[key] = \
                            shard.key_timeouts.get(key, 0) + dt_t
                    if dt_r:
                        shard.key_fab_retries[key] = \
                            shard.key_fab_retries.get(key, 0) + dt_r
            if gated:
                ctl.on_outcome(home, ok and dt_t == 0, self.clock())
        return self._epoch_fence(p, shard, epoch0, lease)

    def _epoch_fence(self, p: Process, shard: LockShard, epoch0: int,
                     lease: Optional[Lease]) -> Optional[Lease]:
        """Discard a grant that raced an epoch bump (shard takeover).

        A transaction that read the shard's key states before a takeover
        committed may have granted against the **dead epoch's** registers —
        state the new home neither sees nor honors.  The fence is checked
        after every grant commits: epoch moved ⇒ the grant never happened
        (its word is a tombstone on a dead host), the caller retries against
        the re-homed shard.  This is the client-side half of the zombie
        fence; the epoch CAS itself keeps two successors from both
        rebuilding.
        """
        if lease is None or shard.epoch == epoch0:
            return lease
        with shard._meta:
            shard.epoch_aborts += 1
            shard.grants -= 1
            shard.grants_by_mode[lease.mode] -= 1
        if lease.mode == LeaseMode.SHARED:
            self._slot_consume(p, lease.key, lease.token)
        return None

    # ------------------------------------------------- inflated (queued) mode
    def _inflated_acquire(self, p: Process, shard: LockShard, key: str,
                          st: _KeyState, ttl: float) -> Optional[Lease]:
        """One non-blocking attempt on an inflated key, through its queue.

        First call enqueues into the caller's class cohort (local clients:
        machine-local CAS, 0 RDMA; remote clients: one rCAS + at most one
        rWrite — the bounded constant the queue buys).  Subsequent calls
        poll: ``parked`` waiters return ``None`` after ONE local read (the
        whole point — no shard CS, no word CAS, no remote op per retry);
        the cohort head attempts the grant.  A head whose handoff never
        comes (dead predecessor, discarded epoch) distrusts the queue after
        ``stale_after_ttls`` TTLs and bypasses to the word directly.
        """
        q = st.infl
        if q is None:
            # Deflated between the routing check and here: normal path.
            granted, _ = self._acquire_group(p, shard, (key,), ttl)
            return granted[0] if granted else None
        waits = self._pid_waits(p)
        ws = waits.get(key)
        if ws is not None and ws[0] is not q:
            del waits[key]  # a discarded epoch's wait: start over
            ws = None
        snap = p.counts.as_tuple()
        enqueued = False
        bypass = False
        blocked = False
        lease: Optional[Lease] = None
        try:
            if ws is None:
                leader = q.enqueue(p)
                waits[key] = [q, self.clock(), False]
                enqueued = True
                if not leader:
                    blocked = True
                    return None  # parked behind a predecessor: poll later
            else:
                verdict = q.poll(p)
                if verdict == "granted":
                    # The predecessor handed the lock over directly: the
                    # word already carries our token — consume the payload
                    # and walk away holding, zero word ops, zero CS.
                    grant = q.take_grant(p)
                    now = self.clock()
                    if grant is not None and now < grant[1]:
                        token, expires = grant
                        ws[1] = now
                        ws[2] = True
                        lease = Lease(key, shard.index, p.pid, token,
                                      expires, ttl, LeaseMode.EXCLUSIVE,
                                      True)
                        return lease
                    # Stamped before we looked, expired before we woke: the
                    # word has (or will) move on without us — fall back to
                    # an ordinary entitled attempt next poll.
                    ws[1] = self.clock()
                    blocked = True
                    return None
                if verdict == "defer":
                    ws[1] = self.clock()  # the queue is live: not stale
                    blocked = True
                    return None
                if verdict == "parked":
                    if (self.clock() - ws[1]
                            < self.inflation.stale_after_ttls * ttl):
                        blocked = True
                        return None
                    bypass = True  # wedged queue: probe the word directly
                else:
                    ws[1] = self.clock()
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
            if enqueued or blocked or lease is not None:
                with shard._meta:
                    if enqueued:
                        shard.queue_enqueues += 1
                    if blocked:
                        # Queue-mode pressure shows up in the same per-key
                        # retry counter the deflated CAS lottery feeds, so
                        # the hot-key report sees inflated keys too.
                        shard.key_retries[key] = \
                            shard.key_retries.get(key, 0) + 1
                    if lease is not None:
                        shard.grants += 1
                        shard.grants_by_mode[LeaseMode.EXCLUSIVE] += 1
                        shard.queue_grants += 1
        return self._inflated_grant(p, shard, key, st, ttl, q, bypass)

    def _inflated_grant(self, p: Process, shard: LockShard, key: str,
                        st: _KeyState, ttl: float, q: InflatedKeyQueue,
                        bypass: bool) -> Optional[Lease]:
        """The cohort head's grant attempt: cheap word pre-check, then the
        ordinary fully-validated critical-section grant.

        ``bypass`` is the disorderly exit: a stale head stops trusting the
        queue, and its grant (if the word really is free/expired) re-seeds
        the key DEFLATED and discards the whole queue — every other waiter
        notices its wait entry points at a dead epoch and starts over.
        """
        snap = p.counts.as_tuple()
        local = p.node == shard.home_host
        lease: Optional[Lease] = None
        expired_over = False
        repaired = False
        discarded: Optional[Tuple[float, int]] = None
        try:
            if not bypass:
                # Pre-check outside the CS: an entitled head polling a
                # still-live holder must not pay a critical section per
                # poll (that is the deflated path's failure mode).
                now = self.clock()
                if local:
                    packed = self.mem.read(p, st.expires)
                    fence = self.mem.read(p, st.fence)
                else:
                    packed, fence = self.mem.post_batch(
                        p, [("read", st.expires), ("read", st.fence)])
                etok, readers, eexp = packed
                if (_trusted(etok, fence, readers)
                        and _FREE_AT < eexp and now < eexp):
                    return None  # live holder: stay entitled, poll again
            alock = shard.alock  # pin: a takeover swaps shard.alock mid-CS
            alock.lock(p)
            writes: List[tuple] = []
            try:
                now = self.clock()
                _holder, (etok, readers, eexp), fence, _barrier = \
                    self._read_key_state(p, shard, st)
                free = eexp <= _FREE_AT
                clobbered = not _trusted(etok, fence, readers)
                if not free and not clobbered and now < eexp:
                    if _dec(readers) > 0:
                        # Reader cohort under the inflated word: arm the
                        # writer drain barrier, same bounded wait as the
                        # deflated path.
                        writes.append(("write", st.intent, eexp))
                else:
                    token = fence + 1
                    keep = st.infl is q and not bypass
                    if self.mem.auto_cas(
                        p, st.expires, (etok, readers, eexp),
                        (token, _enc(0, keep), now + ttl),
                    ) == (etok, readers, eexp):
                        lease = Lease(key, shard.index, p.pid, token,
                                      now + ttl, ttl, LeaseMode.EXCLUSIVE,
                                      keep)
                        fence_val = token
                        if keep:
                            # Still inflated: re-reserve the direct-handoff
                            # block (a bypass grant deflates, so its plain
                            # ``token`` write re-syncs the mirror instead).
                            st.infl_ceiling = fence_val = token + _INFL_RESERVE
                        writes = [
                            ("write", st.fence, fence_val),
                            ("write", st.holder, p.pid),
                            ("write", st.intent, _FREE_AT),
                        ]
                        repaired = clobbered
                        expired_over = (not free) and not clobbered
                        if bypass and st.infl is q:
                            # Disorderly deflation: the queue is gone the
                            # moment the deflated grant lands.
                            st.infl = None
                            self._estimator.mark_deflated(key, now)
                            discarded = (now, token)
            finally:
                alock.unlock(p, piggyback=writes or None)
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
        if lease is not None:
            waits = self._pid_waits(p)
            ws = waits.get(key)
            if lease.inflated and ws is not None and ws[0] is q:
                ws[2] = True  # holding via the queue: release must pass it
            elif ws is not None and ws[0] is q:
                del waits[key]  # granted deflated: no queue obligation
        if discarded is not None:
            self._log_infl_event(discarded[0], "deflate", key,
                                 discarded[1], "bypass")
        with shard._meta:
            if lease is not None:
                shard.grants += 1
                shard.grants_by_mode[LeaseMode.EXCLUSIVE] += 1
                shard.queue_grants += 1
                if expired_over:
                    shard.expirations += 1
                if repaired:
                    shard.repairs += 1
                if discarded is not None:
                    shard.queue_bypasses += 1
                    shard.deflations += 1
            else:
                shard.rejects += 1
                shard.rejects_by_mode[LeaseMode.EXCLUSIVE] += 1
                shard.key_retries[key] = shard.key_retries.get(key, 0) + 1
        return lease

    def _inflated_release(self, p: Process, shard: LockShard, st: _KeyState,
                          lease: Lease) -> Optional[bool]:
        """Direct lock handoff — the inflated hot path's whole payoff.

        A queue-entitled holder with a successor parked behind it does not
        free the word at all: ONE witness CAS moves the word straight to
        ``(token + 1, inflated, now + ttl)`` — ownership transferred, token
        chain advanced — and the cohort pass (the budget write the handoff
        was making anyway) carries ``(token, expires_at)`` to the successor,
        whose next poll returns the lease without touching the word or the
        shard CS.  Remote-holder cost: 1 rCAS + 1 rWrite per handoff,
        regardless of contention; the thundering re-grant (pre-check + CS +
        grant CAS per waiter) vanishes.

        Returns ``None`` when direct handoff does not apply — no successor,
        the cohort-budget fairness rule owes the other cohort a free word
        to CAS for, the epoch's token reservation ran out, the lease is
        already expired, or the caller is not queue-entitled — and the
        ordinary release path (free the word, then pass plain entitlement
        via :meth:`_inflated_handoff`) takes over.
        """
        q = st.infl
        waits = self._pid_waits(p)
        ws = waits.get(lease.key)
        if (q is None or ws is None or ws[0] is not q or not ws[2]):
            return None  # not holding via the live queue epoch
        snap = p.counts.as_tuple()
        passed: Optional[int] = None
        try:
            now = self.clock()
            if (now >= lease.expires_at
                    or lease.token + 1 > st.infl_ceiling
                    or not q.can_direct(p)):
                return None
            token = lease.token + 1
            expires = now + lease.ttl
            witness = lease.witness()
            if self.mem.auto_cas(
                p, st.expires, witness,
                (token, _enc(0, True), expires),
            ) != witness:
                return None  # superseded (zombie): ordinary path cleans up
            del waits[lease.key]
            # The window where a holder dies having moved the word to its
            # successor's token but never written the successor's budget:
            # the successor stalls parked, distrusts the queue after the
            # staleness deadline, and bypasses to the (by then expired)
            # word — the bypass grant deflates the key.
            self._crash_point("deflate.mid", p)
            q.pass_grant(p, token, expires)
            passed = token
            return True
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
            with shard._meta:
                if passed is not None:
                    shard.fast_releases += 1
                    shard.queue_handoffs += 1

    def _inflated_handoff(self, p: Process, shard: LockShard, st: _KeyState,
                          key: str, lease: Lease) -> None:
        """After releasing an inflated-mode grant: pass the queue on, and
        deflate if the key has cooled.

        The releaser hands its cohort's entitlement to its successor (one
        local write — FIFO, no thundering herd) or drains the cohort.  When
        its own cohort drained, the other cohort is empty too, the policy's
        hysteresis says cold, and the word still carries the release value,
        ONE CAS swings the mode bit off — the queue object is discarded
        wholesale (a new epoch allocates fresh registers).
        """
        self._crash_point("deflate.mid", p)
        q = st.infl
        waits = self._pid_waits(p)
        ws = waits.get(key)
        if ws is not None and ws[0] is not q:
            del waits[key]
            return
        if ws is None or not ws[2] or q is None:
            return  # not holding via the queue (pre-inflation holder, or
            # a reclaimed incarnation): nothing to pass — waiters poll the
            # word and self-heal via the staleness bypass if stranded.
        snap = p.counts.as_tuple()
        deflated: Optional[Tuple[float, int]] = None
        try:
            drained = q.release(p)
            del waits[key]
            now = self.clock()
            if (drained and st.infl is q and q.empty(p)
                    and self._estimator.should_deflate(key, now)):
                released_word = (lease.token, _enc(0, True), _FREE_AT)
                if self.mem.auto_cas(
                    p, st.expires, released_word,
                    (lease.token, 0, _FREE_AT),
                ) == released_word:
                    st.infl = None
                    self._estimator.mark_deflated(key, now)
                    deflated = (now, lease.token)
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
            if deflated is not None:
                self._log_infl_event(deflated[0], "deflate", key,
                                     deflated[1], "cool")
            with shard._meta:
                shard.queue_handoffs += 1
                if deflated is not None:
                    shard.deflations += 1

    def acquire(self, p: Process, key: str, ttl: float,
                timeout: Optional[float] = None,
                poll: float = 0.0005,
                mode: LeaseMode = LeaseMode.EXCLUSIVE,
                deadline: Optional[float] = None,
                priority: int = 0) -> Lease:
        """Blocking acquire: retry ``try_acquire`` until granted or timeout.

        Rejected attempts back off with seeded-jitter binary exponential
        delay: base ``poll``, doubling per consecutive reject up to
        ``poll * _BACKOFF_CAP_POLLS``, each sleep scaled by a seeded
        uniform in [0.5, 1.5).  Every retry is a full table transaction
        (remote ops for remote clients), so fixed-interval polling under a
        hot key synchronises the herd — all losers re-arrive together —
        while the jittered doubling spreads them out.  Both the clock and
        the RNG are injected/seeded, so the sim schedule stays a pure
        function of the seed.

        **Deadline propagation.**  ``deadline`` is an *absolute* instant on
        the table's clock (the caller's end-to-end budget, threaded through
        every layer); ``timeout`` remains the legacy relative form, and when
        both are given the earlier wins.  No backoff sleep ever overshoots
        the remaining budget (each sleep is clamped to ``deadline - now``),
        and an explicit deadline that expires raises the typed
        :class:`~repro_torch.core.DeadlineExceeded` — a ``TimeoutError`` subclass,
        so legacy ``except TimeoutError`` handlers keep working, while the
        timeout-only path keeps its historical ``TimeoutError`` message.

        **Load shedding.**  With an explicit ``deadline`` and
        ``priority <= 0``, an attempt whose remaining budget is already
        below the shard's observed time-to-completion (an EWMA over how
        long blocking acquires here take to grant — or to burn their whole
        budget failing) is **shed**: :class:`~repro_torch.core.Overloaded`
        (``reason="shed"``) is raised *before* another retry round spends
        fabric ops that cannot possibly land in budget.
        Positive-priority work is never shed (it may still exceed its
        deadline).  Legacy callers (no explicit deadline) are never shed.

        **Retry budgets.**  When the table was built with an
        :class:`~repro_torch.coord.OverloadPolicy`, each backoff round against a
        *remote* home consumes one token from that host's retry budget;
        a dry budget raises :class:`~repro_torch.core.Overloaded`
        (``reason="budget"``) instead of joining a retry storm.
        """
        explicit = deadline is not None
        if timeout is not None:
            tdl = self.clock() + timeout
            deadline = tdl if deadline is None else min(deadline, tdl)
        shard = self.shards[self.shard_of(key)]
        if explicit:
            # An op entered past its deadline fails fast — zero fabric ops
            # — instead of posting a grant its caller can no longer use.
            # (Timeout-only callers keep their historical one-free-attempt
            # semantics: their budget starts now, by construction.)
            self._deadline_gate("acquire", key, shard, deadline)
        home = shard.home_host
        ctl = self.overload
        delay = poll
        entered = self.clock()

        def _observe(end: float) -> None:
            # Time-to-completion EWMA: how long a blocking acquire on this
            # shard actually takes to resolve — a grant's full retry chain,
            # or the whole burned budget of a deadline failure.  This (not
            # the single-attempt cost) is what the feasibility shed
            # compares the remaining budget against: under load the
            # failures push it up and the shed bites earlier; when load
            # drains the quick grants pull it back down.
            dt = end - entered
            shard.svc_time = (dt if shard.svc_time == 0.0
                              else 0.9 * shard.svc_time + 0.1 * dt)

        while True:
            now = self.clock()
            if (explicit and priority <= 0 and shard.svc_time > 0.0
                    and deadline - now < _SHED_SVC_MARGIN * shard.svc_time):
                # Admission-side feasibility shed: the remaining budget is
                # already below the shard's observed time-to-completion,
                # so this acquire is statistically doomed — refuse locally
                # before posting anything.  A grant produced after its
                # deadline is pure waste (the caller cannot use it), and
                # under overload those late grants are exactly what
                # starves the feasible work behind them.
                with shard._meta:
                    shard.sheds += 1
                raise Overloaded(
                    f"shed: lease on {key!r} infeasible within deadline "
                    f"(remaining {deadline - now:.6f}s < svc "
                    f"{shard.svc_time:.6f}s)", reason="shed", host=home)
            lease = self.try_acquire(p, key, ttl, mode=mode)
            if lease is not None:
                _observe(self.clock())
                return lease
            now = self.clock()
            # >= not >: the backoff clamp below can land the clock EXACTLY
            # on the deadline, and a cost-free attempt would then spin on
            # zero-length sleeps forever under a strict comparison.
            if deadline is not None and now >= deadline:
                _observe(now)
                with shard._meta:
                    shard.deadline_exceeded += 1
                if explicit:
                    raise DeadlineExceeded(
                        f"lease on {key!r}: deadline passed "
                        f"({now - deadline:.6f}s over)")
                raise TimeoutError(f"lease on {key!r} not granted in {timeout}s")
            if (explicit and priority <= 0 and shard.svc_time > 0.0
                    and deadline - now < _SHED_SVC_MARGIN * shard.svc_time):
                # Infeasible: the remaining budget is below the observed
                # time a blocking acquire here takes to resolve.  Shed now —
                # a fast local refusal — instead of burning fabric ops on
                # a lost cause (the brownout half: positive-priority and
                # legacy work never takes this exit).
                with shard._meta:
                    shard.sheds += 1
                raise Overloaded(
                    f"shed: lease on {key!r} infeasible within deadline "
                    f"(remaining {deadline - now:.6f}s < svc "
                    f"{shard.svc_time:.6f}s)", reason="shed", host=home)
            if ctl is not None and p.node != home:
                ctl.spend_retry(home)
            slp = delay * (0.5 + self._rng.random())
            if deadline is not None:
                slp = min(slp, max(0.0, deadline - now))
            self.sleep(slp)
            delay = min(delay * 2.0, poll * _BACKOFF_CAP_POLLS)

    def renew(self, p: Process, lease: Lease, ttl: Optional[float] = None,
              deadline: Optional[float] = None) -> Optional[Lease]:
        """Extend a still-valid lease; ``None`` if it was lost (fencing).

        **EXCLUSIVE fast path** (the common case — the holder renews before
        expiry, with its latest lease object): a single fencing-token-checked
        CAS on the expiry register, no shard ALock.  Zero simulated RDMA ops
        for a local holder, exactly one rCAS for a remote holder.  A zombie
        whose key was re-granted always loses the CAS: the register carries
        the new (larger) fence token, and tokens are never reused (no ABA).

        **EXCLUSIVE slow path** (stale lease object, or contention
        diagnosis): the original fully-validated transaction under the shard
        ALock.

        **SHARED**: a read + CAS extending the cohort's expiry horizon — no
        ALock in any case.  Refused while a writer-intent barrier is armed
        (the drain protocol: the reader keeps its slot until its own expiry,
        but cannot extend), after the holder's own ``expires_at`` (a crashed
        reader cannot resurrect its slot late), or when the generation moved
        on (token mismatch).
        """
        ttl = ttl if ttl is not None else lease.ttl
        shard = self.shards[lease.shard]
        # A renewal entered past its deadline — or past the lease's own
        # remaining TTL, which is the renewal's *implicit* budget (a CAS
        # landing after expiry extends nothing) — fails fast, zero ops.
        self._deadline_gate("renew", lease.key, shard,
                            None if deadline is None
                            else min(deadline, lease.expires_at))
        st = self._key_state(shard, lease.key)
        if lease.mode == LeaseMode.SHARED:
            return self._shared_renew(p, shard, st, lease, ttl)
        snap = p.counts.as_tuple()
        try:
            now = self.clock()
            if now < lease.expires_at:
                witness = lease.witness()
                observed = self.mem.auto_cas(
                    p, st.expires, witness,
                    (lease.token, _enc(0, lease.inflated), now + ttl)
                )
                if observed == witness:
                    with shard._meta:
                        shard.fast_renews += 1
                    return Lease(lease.key, lease.shard, lease.holder_pid,
                                 lease.token, now + ttl, ttl,
                                 LeaseMode.EXCLUSIVE, lease.inflated)
            alock = shard.alock  # pin: a takeover swaps shard.alock mid-CS
            alock.lock(p)
            renewed = None
            try:
                now = self.clock()
                holder, (etok, readers, eexp), fence, _barrier = \
                    self._read_key_state(p, shard, st)
                # A clobbered mirror (etok != fence) means the expiry can no
                # longer be trusted: refuse the renewal (conservative — the
                # holder must re-acquire) rather than extend blindly.  A
                # reader count (readers > 0) under our own token means the
                # key was released and re-opened as a reader generation
                # reusing it: our exclusive lease is long gone.
                if (
                    holder == lease.holder_pid
                    and fence == lease.token
                    and etok == fence
                    and _dec(readers) == 0
                    and _FREE_AT < eexp
                    and now < eexp
                ):
                    # CAS against the read value (the word is CAS-only);
                    # the readers field is written back as observed, so a
                    # renewal never flips the mode bit — a holder whose key
                    # inflated under it renews fine and learns the mode.
                    if self.mem.auto_cas(
                        p, st.expires, (etok, readers, eexp),
                        (lease.token, readers, now + ttl),
                    ) == (etok, readers, eexp):
                        renewed = Lease(lease.key, lease.shard,
                                        lease.holder_pid, lease.token,
                                        now + ttl, ttl, LeaseMode.EXCLUSIVE,
                                        _infl(readers))
            finally:
                alock.unlock(p)
            return renewed
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)

    def _shared_renew(self, p: Process, shard: LockShard, st: _KeyState,
                      lease: Lease, ttl: float) -> Optional[Lease]:
        if not self._slot_owned(p, lease.key, lease.token):
            return None  # released/upgraded already: the slot is not ours
        snap = p.counts.as_tuple()
        renewed = None
        intent_block = False
        try:
            for _ in range(_FAST_ATTEMPTS):
                now = self.clock()
                if now >= lease.expires_at:
                    break  # the holder's own slot lapsed: no resurrection
                packed, fence, barrier = self._shared_read(p, shard, st)
                etok, readers, eexp = packed
                if now < barrier:
                    intent_block = True  # writer draining: stop extending
                    break
                if (etok != lease.token or etok != fence
                        or _dec(readers) <= 0 or now >= eexp):
                    break  # generation moved on, clobbered, or expired
                new = (etok, readers, max(eexp, now + ttl))
                if self.mem.auto_cas(p, st.expires, packed, new) == packed:
                    renewed = Lease(lease.key, lease.shard, lease.holder_pid,
                                    etok, now + ttl, ttl, LeaseMode.SHARED,
                                    _infl(readers))
                    break
                self.mem.yield_point()  # lost to another shared CAS: retry
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        if renewed is not None:
            self._slot_extend(p, lease.key, lease.token, renewed.expires_at)
        with shard._meta:
            if renewed is not None:
                shard.shared_renews += 1
            elif intent_block:
                shard.intent_blocks += 1
        return renewed

    def release(self, p: Process, lease: Lease,
                deadline: Optional[float] = None) -> bool:
        """Release iff the lease is still the current grant (token match).

        **EXCLUSIVE fast path**: one fencing-token-checked CAS writes the
        expiry register to ``(token, 0, FREE)`` — no shard ALock, zero RDMA
        ops for a local holder, one rCAS for a remote one.  The stale
        ``holder`` register left behind is harmless: grant decisions key off
        the packed expiry + fence, and the next grant overwrites it.

        **EXCLUSIVE slow path** (stale lease object whose token is still
        current): the fully-validated transaction under the shard ALock.

        **SHARED**: a read + CAS decrementing the cohort count (the last
        reader out writes FREE) — no ALock in any case.  A lapsed shared
        lease (past its own ``expires_at``) returns ``False``: its slot dies
        with the generation, which closes the ABA window where a zombie
        reader could decrement a *successor* generation that reused the
        token.
        """
        shard = self.shards[lease.shard]
        # Deadline-aware callers fail fast; the abandoned lease expires on
        # its own TTL (a refused release is safe — never a leak, only a
        # bounded wait for successors).
        self._deadline_gate("release", lease.key, shard, deadline)
        st = self._key_state(shard, lease.key)
        if lease.mode == LeaseMode.SHARED:
            return self._shared_release(p, shard, st, lease)
        if lease.inflated and self.inflation is not None:
            handled = self._inflated_release(p, shard, st, lease)
            if handled is not None:
                return handled
        snap = p.counts.as_tuple()
        handoff = lease.inflated
        try:
            witness = lease.witness()
            observed = self.mem.auto_cas(
                p, st.expires, witness,
                (lease.token, _enc(0, lease.inflated), _FREE_AT)
            )
            if observed == witness:
                with shard._meta:
                    shard.fast_releases += 1
                return True
            alock = shard.alock  # pin: a takeover swaps shard.alock mid-CS
            alock.lock(p)
            released = False
            infl_word = False
            writes = None
            try:
                holder, (etok, readers, eexp), fence, _barrier = \
                    self._read_key_state(p, shard, st)
                # Stale (expired and re-granted: the fence moved on), already
                # released (mirror intact at FREE), or superseded by a reader
                # generation reusing our token (readers > 0) ⇒ nothing to do.
                # Releasing the current generation is legal even with a
                # clobbered mirror: the write below re-syncs it.
                if (
                    holder == lease.holder_pid
                    and fence == lease.token
                    and _dec(readers) == 0
                    and not (etok == fence and eexp <= _FREE_AT)
                ):
                    # CAS against the read value (the word is CAS-only);
                    # the readers field carries the mode bit through —
                    # a release never deflates by accident.
                    if self.mem.auto_cas(
                        p, st.expires, (etok, readers, eexp),
                        (lease.token, readers, _FREE_AT),
                    ) == (etok, readers, eexp):
                        writes = [("write", st.holder, _NO_HOLDER)]
                        released = True
                        infl_word = _infl(readers)
            finally:
                alock.unlock(p, piggyback=writes)
            handoff = handoff or (released and infl_word)
            return released
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
            if handoff:
                # Outside the ops accounting above: the handoff does its
                # own snapshot (its queue ops must not be double-counted).
                self._inflated_handoff(p, shard, st, lease.key, lease)

    def _shared_release(self, p: Process, shard: LockShard, st: _KeyState,
                        lease: Lease) -> bool:
        if not self._slot_owned(p, lease.key, lease.token):
            # Double release, or the slot was consumed by an upgrade: the
            # word's count is anonymous, so posting a decrement we do not
            # own would free ANOTHER live reader's slot and let a writer in
            # beside them.  Refuse without touching the word.
            return False
        snap = p.counts.as_tuple()
        released = False
        try:
            for _ in range(_FAST_ATTEMPTS):
                now = self.clock()
                if now >= lease.expires_at:
                    break  # lapsed: the slot dies with the generation (ABA)
                if p.node == shard.home_host:
                    packed = self.mem.read(p, st.expires)
                else:
                    packed = self.mem.rread(p, st.expires)
                etok, readers, eexp = packed
                dec, infl = _dec(readers), _infl(readers)
                if etok != lease.token or dec <= 0:
                    break  # the generation moved on: nothing to release
                new = (etok, _enc(dec - 1, infl),
                       eexp if dec > 1 else _FREE_AT)
                if self.mem.auto_cas(p, st.expires, packed, new) == packed:
                    released = True
                    break
                self.mem.yield_point()  # lost to another shared CAS: retry
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        if released:
            self._slot_consume(p, lease.key, lease.token)
            with shard._meta:
                shard.shared_releases += 1
        return released

    # ------------------------------------------------------ mode transitions
    def upgrade(self, p: Process, lease: Lease,
                ttl: Optional[float] = None) -> Optional[Lease]:
        """SHARED → EXCLUSIVE, iff the caller is the *sole* live reader.

        Runs under the shard ALock (it allocates a token).  With other
        readers present it arms the writer-intent drain barrier (no new
        joins, no renewal extensions) and returns ``None`` — poll until the
        cohort drains.  Two holders upgrading the same key concurrently
        cannot both succeed; bound the polling with a timeout and release on
        failure (the classic S/X upgrade deadlock is the caller's to break).
        The upgraded lease's token is strictly larger than the reader
        generation's, so fencing monotonicity is preserved.
        """
        if lease.mode != LeaseMode.SHARED:
            raise ValueError("upgrade() takes a SHARED lease")
        if not self._slot_owned(p, lease.key, lease.token):
            return None  # released/consumed already: not our slot to trade
        ttl = ttl if ttl is not None else lease.ttl
        shard = self.shards[lease.shard]
        st = self._key_state(shard, lease.key)
        snap = p.counts.as_tuple()
        upgraded = None
        try:
            now = self.clock()
            if now >= lease.expires_at:
                return None
            alock = shard.alock  # pin: a takeover swaps shard.alock mid-CS
            alock.lock(p)
            writes: List[tuple] = []
            try:
                now = self.clock()
                _holder, (etok, readers, eexp), fence, _barrier = \
                    self._read_key_state(p, shard, st)
                if (etok == fence == lease.token and _dec(readers) >= 1
                        and _FREE_AT < eexp and now < eexp
                        and now < lease.expires_at):
                    if _dec(readers) == 1:  # the sole live reader is us
                        token = fence + 1
                        infl = _infl(readers)
                        # CAS, not write: a CS-free join can slip in between
                        # the read and this commit — it must not be stomped
                        # into a phantom reader under our exclusive grant.
                        if self.mem.auto_cas(
                            p, st.expires, (etok, readers, eexp),
                            (token, _enc(0, infl), now + ttl),
                        ) == (etok, readers, eexp):
                            writes = [
                                ("write", st.fence, token),
                                ("write", st.holder, p.pid),
                                ("write", st.intent, _FREE_AT),
                            ]
                            upgraded = Lease(lease.key, lease.shard, p.pid,
                                             token, now + ttl, ttl,
                                             LeaseMode.EXCLUSIVE, infl)
                        else:  # a joiner beat us: drain them first
                            writes = [("write", st.intent, eexp)]
                    else:  # drain the rest of the cohort first
                        writes = [("write", st.intent, eexp)]
            finally:
                alock.unlock(p, piggyback=writes or None)
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
        if upgraded is not None:
            self._slot_consume(p, lease.key, lease.token)
        with shard._meta:
            if upgraded is not None:
                shard.upgrades += 1
                shard.grants += 1
                shard.grants_by_mode[LeaseMode.EXCLUSIVE] += 1
            else:
                shard.rejects += 1
                shard.rejects_by_mode[LeaseMode.EXCLUSIVE] += 1
        if upgraded is None and writes:
            # The upgrader armed the drain barrier and will poll from
            # outside the CS; its death here leaves the barrier to lapse
            # and its shared slot counted until the slot's own horizon
            # (reclaimable by a restarted incarnation).
            self._crash_point("upgrade.mid", p)
        return upgraded

    def downgrade(self, p: Process, lease: Lease,
                  ttl: Optional[float] = None) -> Optional[Lease]:
        """EXCLUSIVE → SHARED without a window for another writer.

        A single fencing-token-checked CAS turns the writer lease into a
        one-reader cohort that keeps the writer's token (the generation the
        readers share) — zero RDMA ops for a local holder, exactly one rCAS
        for a remote one.  Other readers can join the instant the CAS lands.
        ``None`` if the lease was stale (the witness lost).
        """
        if lease.mode != LeaseMode.EXCLUSIVE:
            raise ValueError("downgrade() takes an EXCLUSIVE lease")
        ttl = ttl if ttl is not None else lease.ttl
        shard = self.shards[lease.shard]
        st = self._key_state(shard, lease.key)
        snap = p.counts.as_tuple()
        downgraded = None
        try:
            now = self.clock()
            if now < lease.expires_at:
                witness = lease.witness()
                observed = self.mem.auto_cas(
                    p, st.expires, witness,
                    (lease.token, _enc(1, lease.inflated), now + ttl)
                )
                if observed == witness:
                    downgraded = Lease(lease.key, lease.shard, p.pid,
                                       lease.token, now + ttl, ttl,
                                       LeaseMode.SHARED, lease.inflated)
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        if downgraded is not None:
            self._slot_join(p, lease.key, downgraded.token,
                            downgraded.expires_at)
            with shard._meta:
                shard.downgrades += 1
            if lease.inflated:
                # The writer slot is gone: pass the queue entitlement on
                # (the word is reader-held, so the deflate CAS inside the
                # handoff can never fire — successors drain the cohort via
                # the intent barrier like any queued writer).
                self._inflated_handoff(p, shard, st, lease.key, lease)
        return downgraded

    # -------------------------------------------- optimistic (seqlock) reads
    def _opt_read_wrs(self, st: _KeyState) -> List[tuple]:
        """The seqlock read set, in WR-list execution order: packed word,
        payload, packed word again, intent barrier.  One posting — so one
        doorbell and **zero** CAS — for a remote reader; the async pipeline
        chains several of these into a single posting per host."""
        return [("read", st.expires), ("read", st.payload),
                ("read", st.expires), ("read", st.intent)]

    def _opt_read_verdict(self, now: float, w1: tuple, payload: tuple,
                          w2: tuple, barrier: float) -> Tuple[str, tuple]:
        """Classify one seqlock read set.

        Returns ``("ok", (value, publish_token))``, ``("forward", ())`` for
        a takeover tombstone (chase the forwarding pointer, never serve the
        stale payload), or ``("retry", reason)``.

        Validity argument (the torn/stale-read proof obligation):

        * ``w1 == w2`` — the word did not move across the payload read, so
          no writer *generation change* raced the snapshot.  WR-list
          entries are not mutually atomic (``post_batch`` schedules between
          them), which is exactly why the re-read is required.
        * the word is not a live EXCLUSIVE hold — a live writer may be
          mid-``publish``, so the payload cannot be trusted even under a
          stable word.
        * no writer-intent barrier is armed and the word is not in
          inflated (queued) mode: both states mean a writer is imminent or
          queued, so optimistic reads step aside exactly like shared joins
          do (refuse/retry, per the drain discipline).
        * ``payload_token <= word_token`` — publishes are fenced monotone
          in the writer token, so a payload token *above* the word token
          proves the word read was stale (e.g. a zombie's clobbered
          mirror): retry.  Under that fence, the payload IS the newest
          published value — generations that never published leave it
          untouched, which is fresh, not stale.
        """
        etok, readers, eexp = w1
        if w1 != w2:
            return ("retry", "unstable")
        if etok == _TOMB_TOKEN:
            return ("forward", ())
        if now < barrier:
            return ("retry", "intent")
        if _infl(readers):
            return ("retry", "inflated")
        if _FREE_AT < eexp and now < eexp and _dec(readers) == 0:
            return ("retry", "writer")
        ptok, value = payload
        if ptok > etok:
            return ("retry", "stale-word")
        return ("ok", (value, ptok))

    def read_optimistic(self, p: Process, key: str,
                        poll: float = 0.0005,
                        ttl: float = 1.0,
                        deadline: Optional[float] = None
                        ) -> Optional[Tuple[object, int]]:
        """Lease-free untorn snapshot of ``key``'s published payload.

        The seqlock read at the endpoint of the paper's cost hierarchy:
        read the packed word, read the payload, re-read the word — a
        stable ``(token, readers, expires)`` word with no intent barrier
        armed and no live writer proves an untorn snapshot, with **zero**
        coordination writes.  A home reader touches memory directly (0
        simulated RDMA ops); a remote reader posts the whole read set as
        one WR list: **one doorbell, zero CAS** per attempt.

        *Transient* instability (a torn word, a stale-word fence miss)
        retries in place on the table's seeded exponential backoff up to
        ``_OPT_ATTEMPTS`` times.  *Blocked* verdicts — a live writer, an
        armed intent barrier, an inflated (queued) word — cannot clear
        without writer progress, so the read does NOT spin on them: it
        degrades once to the bounded shared-lease fallback (join, read,
        leave — the cost shape), and if even that single-CAS join is
        refused it returns ``None``, the same non-blocking retry contract
        as :meth:`try_acquire`.  Waiting out a holder belongs at the
        caller (who can yield), never inside the table.  A takeover
        tombstone is chased through the forwarding pointer to the key's
        new home; the stale payload is never returned.

        Returns ``(value, publish_token)`` — ``(None, 0)`` when nothing
        was ever published — or ``None`` when a writer holds the key
        *right now* (back off and call again).  The token lets callers
        order snapshots and reject stale reads downstream, same
        discipline as lease fencing.
        """
        shard = self.shards[self.shard_of(key)]
        self._deadline_gate("read_optimistic", key, shard, deadline)
        delay = poll
        for _ in range(_OPT_ATTEMPTS):
            # Re-resolve placement every attempt: a tombstone chase (or a
            # takeover committing mid-loop) swaps the shard's home and key
            # registers, and the stale _KeyState must not be re-read.
            shard = self.shards[self.shard_of(key)]
            st = self._key_state(shard, key)
            snap = p.counts.as_tuple()
            verdict, out = "retry", ("fabric",)
            try:
                now = self.clock()
                if p.node == shard.home_host:
                    w1 = self.mem.read(p, st.expires)
                    payload = self.mem.read(p, st.payload)
                    w2 = self.mem.read(p, st.expires)
                    barrier = self.mem.read(p, st.intent)
                else:
                    w1, payload, w2, barrier = self.mem.post_batch(
                        p, self._opt_read_wrs(st))
                verdict, out = self._opt_read_verdict(
                    now, w1, payload, w2, barrier)
                if verdict == "forward":
                    # Tombstoned word: decode the forwarding pointer from
                    # the deposed holder register, then retry against the
                    # re-homed registers (the placement re-resolve above
                    # picks them up once the takeover has committed).
                    fwd = forwarded_home(self.mem.auto_read(p, st.holder))
                    out = (fwd,)
            finally:
                self._account(shard, p, snap, LeaseMode.SHARED)
            if verdict == "ok":
                with shard._meta:
                    shard.opt_reads += 1
                return out
            with shard._meta:
                if verdict == "forward":
                    shard.opt_read_fwd += 1
                else:
                    shard.opt_read_retries += 1
            if verdict == "forward":
                continue  # re-resolve immediately: no backoff needed
            now = self.clock()
            if deadline is not None and now >= deadline:
                with shard._meta:
                    shard.deadline_exceeded += 1
                raise DeadlineExceeded(
                    f"read_optimistic of {key!r}: deadline passed")
            if out in ("writer", "intent", "inflated"):
                # Blocked on writer progress: spinning here can only end
                # by expiring the holder's lease (poisonous under the
                # sim's atomic blocking semantics, wasteful under
                # threads).  Degrade now; the caller owns the backoff.
                if out != "inflated":
                    # A shared join refuses on the exact same live-writer
                    # / intent check — don't pay a doomed CAS for it.
                    return None
                break  # inflated: a shared join may legally ride the queue
            ctl = self.overload
            if ctl is not None and p.node != shard.home_host:
                ctl.spend_retry(shard.home_host)
            slp = delay * (0.5 + self._rng.random())
            if deadline is not None:
                slp = min(slp, max(0.0, deadline - now))
            self.sleep(slp)
            delay = min(delay * 2.0, poll * _BACKOFF_CAP_POLLS)
        with shard._meta:
            shard.opt_read_fallbacks += 1
        return self._opt_read_fallback(p, key, ttl)

    def _opt_read_fallback(self, p: Process, key: str, ttl: float
                           ) -> Optional[Tuple[object, int]]:
        """Bounded degradation: read the payload under a shared lease.

        The cohort excludes writers for the lease's lifetime, so a single
        payload register read is untorn by construction; the join/leave
        pair is the shared fast path (one CAS each, zero RDMA for a
        home reader).  ONE non-blocking join attempt: if the single-CAS
        shared join is itself refused (live writer, armed intent,
        inflation drain) the whole read returns ``None`` — retry is the
        caller's, with the caller's own backoff.  The table never waits
        out another process's hold on the read path.
        """
        lease = self.try_acquire(p, key, ttl, mode=LeaseMode.SHARED)
        if lease is None:
            return None
        shard = self.shards[lease.shard]
        st = self._key_state(shard, lease.key)
        snap = p.counts.as_tuple()
        try:
            ptok, value = self.mem.auto_read(p, st.payload)
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        self.release(p, lease)
        return (value, ptok)

    def publish(self, p: Process, lease: Lease, value: object,
                deadline: Optional[float] = None) -> bool:
        """Publish ``key``'s optimistic-read payload under the holder's
        fencing token.

        Only a live EXCLUSIVE holder may publish: the payload register is
        read then CASed to ``(lease.token, value)``, and the CAS is
        **fenced** — a payload already carrying a larger token means a
        newer generation published first (this holder is a zombie), so the
        write is refused rather than regressing the payload.  Tokens are
        monotone across publishes, which is the invariant the seqlock
        readers' staleness check stands on.

        Zero simulated RDMA ops for a home holder (one local read + CAS);
        two doorbells for a remote one.  Returns ``False`` when fenced out
        or expired — like ``renew``, the caller must re-acquire.
        """
        if lease.mode != LeaseMode.EXCLUSIVE:
            raise ValueError("publish() takes an EXCLUSIVE lease")
        shard = self.shards[lease.shard]
        self._deadline_gate("publish", lease.key, shard,
                            None if deadline is None
                            else min(deadline, lease.expires_at))
        st = self._key_state(shard, lease.key)
        snap = p.counts.as_tuple()
        done = False
        try:
            if self.clock() >= lease.expires_at:
                return False
            cur = self.mem.auto_read(p, st.payload)
            for _ in range(_FAST_ATTEMPTS):
                if cur[0] > lease.token:
                    return False  # fenced: a newer generation published
                obs = self.mem.auto_cas(p, st.payload, cur,
                                        (lease.token, value))
                if obs == cur:
                    done = True
                    return True
                cur = obs
                self.mem.yield_point()  # lost to another publish: retry
            return False
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
            if done:
                with shard._meta:
                    shard.publishes += 1

    def attach_pipeline(self, p: Process, client) -> None:
        """Register ``p``'s :class:`~repro_torch.coord.AsyncClient` so hedged
        probes issued by ``p`` ride its flushes (see ``_probe``)."""
        self._pipelines[p.pid] = client

    # ------------------------------------------------------ crash recovery
    def reclaim(self, p: Process, lease: Lease,
                ttl: Optional[float] = None,
                deadline: Optional[float] = None) -> Optional[Lease]:
        """Crash-restart re-entry: re-adopt a still-valid lease.

        ``lease`` is the witness a restarted client replayed from its
        ledger (see ``repro_torch.coord.ledger``).  Reclaim never *extends* a
        dead grant's reach: it succeeds only while the grant is still the
        key's live generation, and a lease the world has moved past
        (expired and re-granted, fenced out, cohort gone) returns ``None``
        — the client re-acquires like anyone else.

        **EXCLUSIVE fast path**: one fencing-token-checked CAS against the
        ledger's witness ``(token, 0, expires_at)``, re-timing the lease to
        ``now + ttl`` — zero simulated RDMA ops for a local holder, exactly
        one rCAS for a remote one, same cost shape as a renewal.  This is
        what makes restart re-entry ~three orders cheaper than the TTL
        wedge.

        **EXCLUSIVE word-probe path**: the witness can be stale-LOW (a
        renewal's CAS landed but its ledger record died with the client),
        so a missed fast CAS probes the authoritative word and CASes
        against *it* — still CS-free, and the probe reuses the failed
        CAS's own observation (a CAS returns the word), so a dead lease
        costs exactly the one rCAS that discovered it and a stale-LOW
        reclaim costs two, with a fresh read doorbell paid only when the
        witness was already expired and no CAS was attempted.  Sound for the same reason the
        renewal fast path is: fence tokens are never reused, so a word
        still carrying OUR token with no readers IS our live grant, and
        re-timing it is just a renewal.  Restart recovery therefore costs
        reads and CASes (doorbells), never a shard ALock critical section.
        Past the word's own expiry the lease is dead — reclaim never
        resurrects.

        **SHARED**: the crashed reader's cohort slot is still counted in
        the packed word (nobody else may decrement it — the client-side
        slot ledger forbids it), so reclaim re-adopts the slot under the
        new incarnation and extends the cohort horizon like a renewal,
        gated on the slot's OWN ``expires_at`` (the same no-resurrection
        ABA posture as ``_shared_release``: past its horizon the slot died
        with its generation) and refused while a writer drain barrier is
        armed.

        The reclaimed EXCLUSIVE lease keeps the *original* ``holder_pid``:
        that pid is the grant's identity (the ``holder`` register still
        names it, and pids are never reused), so the slow renew/release
        validations keep working for the new incarnation.  SHARED reclaims
        carry the new pid — cohort slots are owned per live process.
        """
        if ttl is None:
            ttl = lease.ttl
        shard = self.shards[lease.shard]
        # Restart recovery races the TTL wedge: a reclaim entered past the
        # caller's budget fails fast and the client re-acquires instead.
        self._deadline_gate("reclaim", lease.key, shard, deadline)
        st = self._key_state(shard, lease.key)
        if lease.mode == LeaseMode.SHARED:
            return self._shared_reclaim(p, shard, st, lease, ttl)
        snap = p.counts.as_tuple()
        got: Optional[Lease] = None
        fast = False
        try:
            now = self.clock()
            packed = None
            if now < lease.expires_at:
                witness = lease.witness()
                observed = self.mem.auto_cas(
                    p, st.expires, witness,
                    (lease.token, _enc(0, lease.inflated), now + ttl)
                )
                if observed == witness:
                    got = Lease(lease.key, lease.shard, lease.holder_pid,
                                lease.token, now + ttl, ttl,
                                LeaseMode.EXCLUSIVE, lease.inflated)
                    fast = True
                else:
                    # A failed CAS *returns* the word: the probe below
                    # starts from that observation instead of paying a
                    # fresh read doorbell for the same value.
                    packed = observed
            if got is None:
                for _ in range(_FAST_ATTEMPTS):
                    now = self.clock()
                    if deadline is not None and now >= deadline:
                        break  # budget gone mid-probe: stop cleanly
                    if packed is None:
                        # The word probe may hedge one re-post under
                        # overload control (see _hedged_read).
                        packed = self._hedged_read(p, st.expires, shard)
                    etok, readers, eexp = packed
                    if (etok != lease.token or _dec(readers) != 0
                            or eexp <= _FREE_AT or now >= eexp):
                        break  # expired, re-granted, or a reader generation
                    # The readers field is written back as observed: a
                    # reclaim learns the word's current mode (the key may
                    # have inflated or deflated since the ledger record).
                    observed = self.mem.auto_cas(
                        p, st.expires, packed, (lease.token, readers,
                                                now + ttl)
                    )
                    if observed == packed:
                        got = Lease(lease.key, lease.shard, lease.holder_pid,
                                    lease.token, now + ttl, ttl,
                                    LeaseMode.EXCLUSIVE, _infl(readers))
                        break
                    packed = observed  # lost a word race: the loser's
                    self.mem.yield_point()  # observation feeds the retry
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
        with shard._meta:
            if got is not None:
                shard.reclaims += 1
                if fast:
                    shard.reclaim_fast += 1
                else:
                    shard.reclaim_slow += 1
            else:
                shard.reclaim_rejects += 1
        return got

    def _shared_reclaim(self, p: Process, shard: LockShard, st: _KeyState,
                        lease: Lease, ttl: float) -> Optional[Lease]:
        snap = p.counts.as_tuple()
        got: Optional[Lease] = None
        try:
            for _ in range(_FAST_ATTEMPTS):
                now = self.clock()
                if now >= lease.expires_at:
                    break  # the slot's horizon passed: it died with the
                    # generation (no resurrection — the ABA guard that
                    # keeps a reclaim from decrementing, later, a
                    # successor generation that reused the token)
                packed, fence, barrier = self._shared_read(p, shard, st)
                etok, readers, eexp = packed
                if now < barrier:
                    break  # writer draining: no extensions, no re-adoption
                if (etok != lease.token or etok != fence
                        or _dec(readers) <= 0 or now >= eexp):
                    break  # generation moved on, clobbered, or expired
                new = (etok, readers, max(eexp, now + ttl))
                if self.mem.auto_cas(p, st.expires, packed, new) == packed:
                    got = Lease(lease.key, lease.shard, p.pid, etok,
                                now + ttl, ttl, LeaseMode.SHARED,
                                _infl(readers))
                    break
                self.mem.yield_point()  # lost to another shared CAS: retry
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        if got is not None:
            self._slot_join(p, lease.key, got.token, got.expires_at)
        with shard._meta:
            if got is not None:
                shard.reclaims += 1
                shard.reclaim_shared += 1
            else:
                shard.reclaim_rejects += 1
        return got

    def reclaim_orphan(self, p: Process, key: str,
                       dead_pids: Sequence[int],
                       ttl: float) -> Optional[Lease]:
        """Adopt a live EXCLUSIVE grant left by a dead incarnation.

        The one crash window reclaim-by-witness cannot cover: the grant
        CAS committed but the client died before its ledger recorded the
        token (``grant.pre_ledger``, or mid-batch).  The restarted client
        knows only that an *intent* is dangling — but the ``holder``
        register names the grantee, and pids are never reused, so under
        the shard ALock a live word whose holder is one of the caller's
        dead pids is provably the caller's lost grant.  The CAS re-times
        it and the holder register is re-pointed at the new incarnation.

        Probe cost is one CS per dangling intent — proportional to what
        was in flight at the crash, not to the keyspace (the adaptive
        recovery-cost shape of Dhoked & Mittal's RME transformation).
        """
        if ttl <= 0:
            raise ValueError("ttl must be > 0")
        dead = set(dead_pids)
        shard = self.shards[self.shard_of(key)]
        st = self._key_state(shard, key)
        snap = p.counts.as_tuple()
        got: Optional[Lease] = None
        writes = None
        try:
            if dead:
                alock = shard.alock  # pin across a concurrent takeover
                alock.lock(p)
                try:
                    now = self.clock()
                    holder, (etok, readers, eexp), fence, _barrier = \
                        self._read_key_state(p, shard, st)
                    if (
                        holder in dead
                        and etok == fence
                        and _dec(readers) == 0
                        and _FREE_AT < eexp
                        and now < eexp
                    ):
                        if self.mem.auto_cas(
                            p, st.expires, (etok, readers, eexp),
                            (etok, readers, now + ttl),
                        ) == (etok, readers, eexp):
                            writes = [("write", st.holder, p.pid)]
                            got = Lease(key, shard.index, p.pid, etok,
                                        now + ttl, ttl, LeaseMode.EXCLUSIVE,
                                        _infl(readers))
                finally:
                    alock.unlock(p, piggyback=writes)
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
        with shard._meta:
            shard.orphan_probes += 1
            if got is not None:
                shard.orphan_adopts += 1
                shard.reclaims += 1
        return got

    def reconstruct_shard(self, p: Process, shard_index: int,
                          records: Iterable, fence_slack: int = 16,
                          ) -> Dict[str, int]:
        """Audit-and-repair one shard's registers after a home-host restart.

        ``records`` is the merged record stream from surviving clients'
        ledgers (duck-typed: anything with ``op``/``key``/``token``/
        ``expires_at`` — see ``repro_torch.coord.ledger.LedgerRecord``).  For
        every ledgered key homed on this shard, under the shard ALock:

        * **intact** — the fence register matches the word's generation and
          is at least the largest token any ledger has seen: nothing to do.
        * **fence_repaired** — the word still carries a ledger-live lease
          but the fence register lagged (lost with the host): the fence is
          re-seeded from the word, preserving the lease (its holder can
          still reclaim it).
        * **reset** — anything else (word and fence disagree with the
          ledgers): the key is re-seeded FREE under a fence advanced past
          everything observed **plus ``fence_slack``**, covering grants
          that died unrecorded in the pre-ledger window — so no
          post-reconstruction grant can ever reuse a token some downstream
          resource has already honored.

        Returns the per-action counts.  Token monotonicity is the one
        invariant reconstruction must preserve at all costs; availability
        of individual leases is sacrificed whenever the state cannot be
        trusted (a reset key's holder simply re-acquires).
        """
        shard = self.shards[shard_index]
        ledger_max: Dict[str, int] = {}
        grants: Dict[str, Dict[int, tuple]] = {}
        tombs: Dict[str, set] = {}
        for rec in records:
            key = rec.key
            if not key or rec.op not in ("grant", "reclaim", "renew",
                                         "release", "lost"):
                continue
            if self.shard_of(key) != shard_index:
                continue
            if rec.token > ledger_max.get(key, 0):
                ledger_max[key] = rec.token
            if rec.op in ("grant", "reclaim"):
                grants.setdefault(key, {})[rec.token] = (rec.token,
                                                         rec.expires_at)
            elif rec.op == "renew":
                cur = grants.get(key, {}).get(rec.token)
                if cur is not None and rec.expires_at > cur[1]:
                    grants[key][rec.token] = (rec.token, rec.expires_at)
            else:  # release / lost
                tombs.setdefault(key, set()).add(rec.token)
        report = {"intact": 0, "fence_repaired": 0, "reset": 0}
        for key in sorted(ledger_max):
            # The plausibly-live generation: the largest untombstoned grant
            # (cross-ledger merge order is not time order, so selection is
            # by token — tokens ARE the time order).
            live_tok = max(
                (t for t in grants.get(key, {}) if t not in tombs.get(key, set())),
                default=None,
            )
            st = self._key_state(shard, key)
            snap = p.counts.as_tuple()
            writes: List[tuple] = []
            action = "reset"
            try:
                alock = shard.alock  # pin across a concurrent takeover
                alock.lock(p)
                try:
                    now = self.clock()
                    _holder, (etok, readers, eexp), fence, _barrier = \
                        self._read_key_state(p, shard, st)
                    lmax = ledger_max[key]
                    word_live = _FREE_AT < eexp and now < eexp
                    if etok == fence and fence >= lmax:
                        action = "intact"  # registers survived the restart
                    elif (live_tok is not None and etok == live_tok
                          and word_live and fence <= etok and etok >= lmax):
                        # The word is authoritative for a ledger-live lease;
                        # only the fence register lagged.  Re-seed it from
                        # the word — the lease stays reclaimable.
                        writes = [("write", st.fence, etok)]
                        action = "fence_repaired"
                    else:
                        nf = max(fence, etok, lmax) + fence_slack
                        packed = (etok, readers, eexp)
                        # CAS, not write (the word is CAS-only: a CS-free
                        # shared join can land between read and commit);
                        # a lost race re-reads and retries — the joiner
                        # reused the same untrusted generation, which is
                        # exactly what the reset must displace.
                        for _ in range(_FAST_ATTEMPTS):
                            if self.mem.auto_cas(
                                p, st.expires, packed, (nf, 0, _FREE_AT),
                            ) == packed:
                                writes = [
                                    ("write", st.fence, nf),
                                    ("write", st.holder, _NO_HOLDER),
                                    ("write", st.intent, _FREE_AT),
                                ]
                                if st.infl is not None:
                                    # Re-seeded FREE and DEFLATED: a reset
                                    # key's queue state is as untrusted as
                                    # its registers were.
                                    st.infl = None
                                    if self._estimator is not None:
                                        self._estimator.mark_deflated(
                                            key, now)
                                    self._log_infl_event(now, "deflate",
                                                         key, nf,
                                                         "reconstruct")
                                    with shard._meta:
                                        shard.deflations += 1
                                break
                            packed = self.mem.auto_read(p, st.expires)
                            self.mem.yield_point()
                finally:
                    alock.unlock(p, piggyback=writes or None)
            finally:
                self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
            report[action] += 1
        with shard._meta:
            shard.reconstructions += sum(report.values())
            shard.reconstruct_resets += report["reset"]
        return report

    def takeover_shard(self, p: Process, shard_index: int,
                       records: Iterable,
                       membership=None, fence_slack: int = 16,
                       ) -> Optional[Dict[str, int]]:
        """Epoch-fenced automatic takeover of a dead home's shard.

        The successor (``p`` must run ON the new home) re-homes the shard
        onto its own host: unlike :meth:`reconstruct_shard` — which audits
        the *surviving* registers after the home restarts — takeover cannot
        touch the old registers at all (they died with the host), so it
        rebuilds the shard from the merged ledger stream alone.  The
        sequence, in fencing order:

        1. **Partition guard** — if ``membership`` is given (duck-typed:
           ``can_serve()`` / ``confirm_dead(host)``), refuse without a live
           majority attestation: a minority island must degrade to
           read-only lease validation, never re-home shards.
        2. **Epoch CAS** — bump the shard's epoch register, which lives on
           the rank-order first successor rather than the home exactly so
           it survives the home's death.  Losing the CAS means another
           successor already owns the rebuild: abort.
        3. **Liveness re-probe** — after winning the epoch, re-probe the
           "dead" host's member lease: a live unexpired word means we were
           on the wrong side of a heal (the burned epoch is harmless — it
           only ever fences grants *we* would have made).
        4. **Rebuild** — fold the ledgers exactly like reconstruction:
           a key whose largest ledgered token is an unexpired, untombstoned
           EXCLUSIVE grant is installed *intact* on the new home (word,
           fence, and holder match the lease — the third-party holder's
           witness CASes keep working across the re-homing); every other
           ledgered key is re-seeded FREE under a fence advanced
           ``fence_slack`` past everything observed (covering grants that
           died unrecorded — same token-monotonicity posture as
           reconstruction; shared generations are reset, readers issue no
           fenced writes and simply re-join).  All registers (including a
           fresh ALock) carry epoch-suffixed names; keys never ledgered by
           any surviving client are lost with the host.
        5. **Tombstones + forwarding** — one probe decides reachability of
           the deposed home; if it answers (deposed-but-alive, e.g. healed
           partition loser), every old key word is tombstoned with a
           never-expiring sentinel generation and its holder register
           becomes a forwarding pointer to the new home; the shard's
           forwarding register (next to the epoch register) is updated
           either way.  If the probe times out the old registers are
           unreachable garbage and the epoch fence alone handles zombies.
        6. **Swap** — home_host / keys / ALock / epoch swing in one
           ``_meta``-guarded step; in-flight transactions pinned to the old
           ALock drain against dead registers and are discarded by
           :meth:`_epoch_fence`.

        Returns the rebuild report, or ``None`` on refusal/abort.
        """
        shard = self.shards[shard_index]
        new_home = p.node
        old_home = shard.home_host
        if new_home == old_home:
            raise ValueError("takeover_shard: successor must be a new home "
                             "(use reconstruct_shard after a home restart)")
        snap = p.counts.as_tuple()
        try:
            if membership is not None and not membership.can_serve():
                with shard._meta:
                    shard.takeover_refusals += 1
                return None
            # Witness reachability is decided by a non-blocking probe: a
            # takeover must never ride the fabric's heal-wait across a
            # cut.  One atomic recovery step spanning a heal would read a
            # post-heal view in which the "dead" host's renewals could
            # not yet have landed — and the liveness re-probe below would
            # wrongly confirm.  Unreachable witness: retry next sweep.
            # The probe may hedge one re-posting under overload control: a
            # takeover stalled on one lost witness probe delays every
            # client of the dead home's shards.
            if self._probe(p, shard.epoch_reg, shard) is TIMEOUT:
                with shard._meta:
                    shard.takeover_aborts += 1
                return None
            # The epoch register is authoritative (the python-side
            # shard.epoch mirror only advances on commit: aborted attempts
            # burn register epochs without un-fencing anything).
            reg_epoch = self.mem.auto_read(p, shard.epoch_reg)
            if self.mem.auto_cas(p, shard.epoch_reg, reg_epoch,
                                 reg_epoch + 1) != reg_epoch:
                with shard._meta:
                    shard.takeover_aborts += 1
                return None
            new_epoch = reg_epoch + 1
            if membership is not None and not membership.confirm_dead(old_home):
                with shard._meta:
                    shard.takeover_aborts += 1
                return None

            # ---- ledger fold (same selection rules as reconstruct_shard)
            ledger_max: Dict[str, int] = {}
            grants: Dict[str, Dict[int, tuple]] = {}
            tombs: Dict[str, set] = {}
            for rec in records:
                key = rec.key
                if not key or rec.op not in ("grant", "reclaim", "renew",
                                             "release", "lost"):
                    continue
                if self.shard_of(key) != shard_index:
                    continue
                if rec.token > ledger_max.get(key, 0):
                    ledger_max[key] = rec.token
                if rec.op in ("grant", "reclaim"):
                    grants.setdefault(key, {})[rec.token] = (
                        rec.token, rec.expires_at, rec.pid, rec.mode)
                elif rec.op == "renew":
                    cur = grants.get(key, {}).get(rec.token)
                    if cur is not None and rec.expires_at > cur[1]:
                        grants[key][rec.token] = (rec.token, rec.expires_at,
                                                  cur[2], cur[3])
                else:  # release / lost
                    tombs.setdefault(key, set()).add(rec.token)

            # ---- rebuild on the new home (all ops local to `p`)
            prefix = f"{self.name}.s{shard_index}.e{new_epoch}"
            new_alock = ALock(self.mem, new_home, shard.init_budget,
                              name=prefix)
            new_keys: Dict[str, _KeyState] = {}
            now = self.clock()
            report = {"epoch": new_epoch, "intact": 0, "reset": 0,
                      "tombstoned": 0}
            for key in sorted(ledger_max):
                live_tok = max(
                    (t for t in grants.get(key, {})
                     if t not in tombs.get(key, set())),
                    default=None,
                )
                lmax = ledger_max[key]
                st = _KeyState(self.mem, new_home,
                               f"{prefix}.k{stable_key_hash(key):016x}")
                live = (live_tok is not None and live_tok == lmax
                        and grants[key][live_tok][3] == int(LeaseMode.EXCLUSIVE)
                        and grants[key][live_tok][1] > now)
                if live:
                    tok, exp, pid, _m = grants[key][live_tok]
                    self.mem.write(p, st.expires, (tok, 0, exp))
                    self.mem.write(p, st.fence, tok)
                    self.mem.write(p, st.holder, pid)
                    report["intact"] += 1
                else:
                    nf = lmax + fence_slack
                    self.mem.write(p, st.expires, (nf, 0, _FREE_AT))
                    self.mem.write(p, st.fence, nf)
                    report["reset"] += 1
                new_keys[key] = st

            # ---- tombstone the deposed home's registers, if it answers
            old_keys = dict(shard.keys)
            if old_keys:
                first = next(iter(old_keys.values()))
                if self._probe(p, first.expires, shard) is not TIMEOUT:
                    try:
                        self.mem.post_batch(p, [
                            w for ost in old_keys.values()
                            for w in (("write", ost.expires,
                                       (_TOMB_TOKEN, 0, _TOMB_AT)),
                                      ("write", ost.holder,
                                       _fwd_enc(new_home)))
                        ])
                        report["tombstoned"] = len(old_keys)
                    except RemoteTimeout:
                        pass  # it died under us: the epoch fence suffices
            self.mem.auto_write(p, shard.fwd_reg, new_home)

            # ---- commit: one atomic swap, then the epoch fence is live
            with shard._meta:
                shard.home_host = new_home
                shard.alock = new_alock
                shard.keys = new_keys
                shard.epoch = new_epoch
                shard.takeovers += 1
                shard.rehomed_keys += len(new_keys)
                shard.reconstructions += report["intact"] + report["reset"]
                shard.reconstruct_resets += report["reset"]
            return report
        finally:
            # Classified by hand: the commit flips home_host to p.node, so
            # _account would file the successor's recovery ops (epoch CAS
            # on the witness, tombstones on the deposed home) as LOCAL.
            # Takeover traffic is remote by construction — the guard above
            # rejects p.node == old_home.
            with shard._meta:
                shard.stats[REMOTE].add_since(p.counts, snap)
                shard.mode_stats[(LeaseMode.EXCLUSIVE, REMOTE)].add_since(
                    p.counts, snap)

    # --------------------------------------------------------------- batches
    def batch_order(self, keys: Iterable[str]) -> List[str]:
        """The deadlock-avoidance total order:
        ``(shard_of(key) % num_hosts, shard_of(key), key)``.

        Primary-by-**static-home** (the shard's placement-time host,
        ``shard % num_hosts`` — a pure function of the key, identical in
        every process, never moved by a takeover), so shard groups homed
        on the same fabric peer are *adjacent* and ``acquire_batch`` can
        chain their WR lists into one posting per destination host.  Any
        total order all clients share preserves deadlock freedom; this one
        additionally makes the doorbell merge order-compliant.
        """
        nh = self.num_hosts
        return sorted(
            set(keys),
            key=lambda k: (self.shard_of(k) % nh, self.shard_of(k), k))

    def acquire_batch(self, p: Process, keys: Sequence[str], ttl: float,
                      timeout: Optional[float] = None,
                      poll: float = 0.0005,
                      mode: LeaseMode = LeaseMode.EXCLUSIVE,
                      deadline: Optional[float] = None) -> List[Lease]:
        """Acquire every key (deduplicated) in the global key order.

        Keys are grouped by shard (the global order is primary-by-shard, so
        groups are contiguous); EXCLUSIVE groups take each shard's ALock
        **once** for all of that shard's keys — O(distinct shards) critical
        sections instead of O(keys), with the group's register reads and
        writes each coalesced into one doorbell for remote clients — while
        SHARED groups join each key's cohort CS-free.  Deadlock freedom is
        preserved: grants still happen in the global order, and a blocked
        key is waited on *outside* the critical section while holding only
        smaller keys.

        All-or-nothing: ``timeout`` (relative) and/or ``deadline``
        (absolute, the earlier wins) bound the *whole batch*; on expiry,
        already-granted leases are released and ``TimeoutError`` is raised
        (:class:`~repro_torch.core.DeadlineExceeded` when the bound came from an
        explicit ``deadline``).  Backoff sleeps never overshoot the
        remaining budget.  A ``RemoteTimeout`` that escapes the fabric's
        bounded retries mid-batch triggers the same suffix rollback: the
        held prefix is released best-effort (a release that itself times
        out is abandoned to TTL expiry — reclaimable via the ledger), so
        no grant is left held by a caller that reported failure.
        """
        if ttl <= 0:
            raise ValueError("ttl must be > 0")
        ordered = self.batch_order(keys)
        explicit = deadline is not None
        if timeout is not None:
            tdl = self.clock() + timeout
            deadline = tdl if deadline is None else min(deadline, tdl)
        if explicit and ordered:
            # Entered past the deadline: fail fast before granting (and
            # then rolling back) a prefix nobody can use.
            self._deadline_gate("acquire_batch", ordered[0],
                                self.shards[self.shard_of(ordered[0])],
                                deadline)
        held: List[Lease] = []
        try:
            i, n = 0, len(ordered)
            while i < n:
                # One *run*: the maximal span of consecutive shard groups
                # sharing a (runtime) home host.  The static-home-major
                # order makes same-home groups adjacent, so an EXCLUSIVE
                # run transacts them together — the cross-shard-group WR
                # lists chain into one posting per destination host
                # instead of one commit doorbell per group.  SHARED mode
                # keeps per-group processing (CS-free joins have nothing
                # to merge).
                home = self.shards[self.shard_of(ordered[i])].home_host
                j = i + 1
                if mode == LeaseMode.EXCLUSIVE:
                    while (j < n and self.shards[
                            self.shard_of(ordered[j])].home_host == home):
                        j += 1
                else:
                    sidx = self.shard_of(ordered[i])
                    while j < n and self.shard_of(ordered[j]) == sidx:
                        j += 1
                run_keys = ordered[i:j]
                start = 0
                delay = poll
                while start < len(run_keys):
                    rem = run_keys[start:]
                    groups: List[Tuple[LockShard, List[str]]] = []
                    a = 0
                    while a < len(rem):
                        sidx = self.shard_of(rem[a])
                        b = a + 1
                        while b < len(rem) and self.shard_of(rem[b]) == sidx:
                            b += 1
                        groups.append((self.shards[sidx], rem[a:b]))
                        a = b
                    epochs = {sh.index: sh.epoch for sh, _ in groups}
                    if mode == LeaseMode.SHARED or len(groups) == 1:
                        granted, blocked = self._acquire_group(
                            p, groups[0][0], groups[0][1], ttl, mode)
                    else:
                        granted, blocked = self._acquire_run(p, groups, ttl)
                    # Epoch fencing, run-aware: grants land as a prefix of
                    # ``rem``, but the fence discards per *shard* — a
                    # surviving grant sitting past a discarded one would
                    # break the held-prefix invariant, so release it and
                    # resume the retry loop at the first discard.
                    resume: Optional[int] = None
                    survivors: List[Tuple[int, Lease]] = []
                    for gi, g in enumerate(granted):
                        fenced = self._epoch_fence(
                            p, self.shards[g.shard], epochs[g.shard], g)
                        if fenced is None:
                            if resume is None:
                                resume = gi
                        else:
                            survivors.append((gi, fenced))
                    if resume is None:
                        held.extend(g for _gi, g in survivors)
                        start += len(granted)
                        progressed = bool(granted)
                    else:
                        for gi, g in survivors:
                            if gi < resume:
                                held.append(g)
                            else:
                                try:
                                    self.release(p, g)
                                except RemoteTimeout:
                                    pass
                        start += resume
                        progressed = resume > 0
                    if progressed:
                        delay = poll  # progress: reset the backoff ladder
                    if blocked and start < len(run_keys):
                        shard = self.shards[self.shard_of(run_keys[start])]
                        now = self.clock()
                        # >= not >: see acquire — the clamp can land the
                        # clock exactly on the deadline.
                        if deadline is not None and now >= deadline:
                            with shard._meta:
                                shard.deadline_exceeded += 1
                            if explicit:
                                raise DeadlineExceeded(
                                    f"batch lease on {run_keys[start]!r}: "
                                    f"deadline passed")
                            raise TimeoutError(
                                f"batch lease on {run_keys[start]!r} not "
                                f"granted in {timeout}s"
                            )
                        # Same seeded-jitter exponential backoff as
                        # ``acquire`` (see there for the rationale), clamped
                        # to the batch's remaining budget.
                        slp = delay * (0.5 + self._rng.random())
                        if deadline is not None:
                            slp = min(slp, max(0.0, deadline - now))
                        self.sleep(slp)
                        delay = min(delay * 2.0, poll * _BACKOFF_CAP_POLLS)
                i = j
                if i < n:
                    # Between two host runs: a prefix of the batch is
                    # held; death here abandons it under a dead pid (the
                    # recoverable client's dangling intents drive the
                    # orphan probe on restart).
                    self._crash_point("batch.mid", p)
        except (TimeoutError, RemoteTimeout, Overloaded):
            # All-or-nothing rollback (TimeoutError covers DeadlineExceeded).
            # Releases are best-effort: over a faulty fabric the rollback
            # itself can time out, and an unreleased lease merely waits out
            # its TTL (no orphan — the ledger, if any, still witnesses it).
            for lease in held:
                try:
                    self.release(p, lease)
                except RemoteTimeout:
                    pass
            raise
        return held

    def release_batch(self, p: Process, leases: Sequence[Lease]) -> int:
        """Release a batch (any order); returns how many were still current.

        Mirrors ``acquire_batch``'s shard grouping: leases are grouped by
        shard, each group's EXCLUSIVE fast-path CASes are coalesced into
        **one doorbell** for remote clients (one posting for the whole
        group instead of one per lease), SHARED releases batch their cohort
        reads and decrement CASes the same way, and whatever falls off the
        fast path is settled under **one** shard ALock critical section per
        group — the exact structure the old per-key loop paid for K times.
        """
        by_shard: Dict[int, List[Lease]] = {}
        for lease in leases:
            by_shard.setdefault(lease.shard, []).append(lease)
        released = 0
        # Cross-shard-group coalescing (the release half of the batch
        # doorbell fix): exclusive witness CASes carry no ordering
        # constraint, so every shard group homed on the same REMOTE host
        # posts its fast-path CASes in ONE doorbell for the whole cluster.
        by_home: Dict[int, List[int]] = {}
        for sidx in sorted(by_shard):
            by_home.setdefault(self.shards[sidx].home_host, []).append(sidx)
        for home in sorted(by_home):
            sidxs = by_home[home]
            if p.node != home and len(sidxs) > 1:
                released += self._release_cluster(p, sidxs, by_shard)
            else:
                for sidx in sidxs:
                    released += self._release_group(
                        p, self.shards[sidx], by_shard[sidx])
        return released

    def _release_cluster(self, p: Process, sidxs: Sequence[int],
                         by_shard: Dict[int, List[Lease]]) -> int:
        """Release several shard groups homed on one remote host: one
        merged witness-CAS posting for every group's EXCLUSIVE fast path,
        then the usual per-shard slow/shared settlement for the rest."""
        excl: List[Tuple[LockShard, Lease, _KeyState]] = []
        for sidx in sidxs:
            shard = self.shards[sidx]
            for lease in by_shard[sidx]:
                if lease.mode == LeaseMode.EXCLUSIVE:
                    excl.append((shard, lease,
                                 self._key_state(shard, lease.key)))
        released = 0
        slow: Dict[int, List[Lease]] = {}
        handoffs: List[Tuple[LockShard, _KeyState, Lease]] = []
        if excl:
            snap = p.counts.as_tuple()
            try:
                observed = self.mem.post_batch(p, [
                    ("cas", st.expires, lease.witness(),
                     (lease.token, _enc(0, lease.inflated), _FREE_AT))
                    for _sh, lease, st in excl
                ])
            finally:
                # Merged posting: accounted to the cluster's first shard
                # (same host, same class — totals stay exact).
                self._account(excl[0][0], p, snap, LeaseMode.EXCLUSIVE)
            nfast: Dict[int, int] = {}
            for (shard, lease, st), obs in zip(excl, observed):
                if obs == lease.witness():
                    nfast[shard.index] = nfast.get(shard.index, 0) + 1
                    if lease.inflated:
                        handoffs.append((shard, st, lease))
                else:
                    slow.setdefault(shard.index, []).append(lease)
            for sidx, cnt in nfast.items():
                with self.shards[sidx]._meta:
                    self.shards[sidx].fast_releases += cnt
                released += cnt
            for shard, st, lease in handoffs:
                self._inflated_handoff(p, shard, st, lease.key, lease)
            for sidx in sidxs:
                if sidx in slow:
                    released += self._release_group_slow(
                        p, self.shards[sidx], slow[sidx])
        for sidx in sidxs:
            shrd = [l for l in by_shard[sidx]
                    if l.mode == LeaseMode.SHARED]
            if shrd:
                released += self._release_group_shared(
                    p, self.shards[sidx], shrd)
        return released

    def _release_group(self, p: Process, shard: LockShard,
                       group: Sequence[Lease]) -> int:
        local = p.node == shard.home_host
        released = 0
        # --- EXCLUSIVE leases: witness CASes, one doorbell for the group.
        excl = [l for l in group if l.mode == LeaseMode.EXCLUSIVE]
        slow: List[Lease] = []
        handoffs: List[Tuple[_KeyState, Lease]] = []
        if excl:
            snap = p.counts.as_tuple()
            nfast = 0
            try:
                sts = [self._key_state(shard, l.key) for l in excl]
                if local:
                    observed = [
                        self.mem.cas(p, st.expires, l.witness(),
                                     (l.token, _enc(0, l.inflated), _FREE_AT))
                        for st, l in zip(sts, excl)
                    ]
                else:
                    observed = self.mem.post_batch(p, [
                        ("cas", st.expires, l.witness(),
                         (l.token, _enc(0, l.inflated), _FREE_AT))
                        for st, l in zip(sts, excl)
                    ])
                for lease, st, obs in zip(excl, sts, observed):
                    if obs == lease.witness():
                        nfast += 1
                        if lease.inflated:
                            handoffs.append((st, lease))
                    else:
                        slow.append(lease)
            finally:
                self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
            with shard._meta:
                shard.fast_releases += nfast
            released += nfast
            for st, lease in handoffs:
                self._inflated_handoff(p, shard, st, lease.key, lease)
            if slow:
                released += self._release_group_slow(p, shard, slow)
        # --- SHARED leases: cohort reads + decrement CASes, batched.
        shrd = [l for l in group if l.mode == LeaseMode.SHARED]
        if shrd:
            released += self._release_group_shared(p, shard, shrd)
        return released

    def _release_group_slow(self, p: Process, shard: LockShard,
                            group: Sequence[Lease]) -> int:
        """Slow-path releases for one shard, in ONE critical section."""
        states = [self._key_state(shard, l.key) for l in group]
        snap = p.counts.as_tuple()
        local = p.node == shard.home_host
        released = 0
        writes: List[tuple] = []
        handoffs: List[Tuple[_KeyState, Lease]] = []
        try:
            alock = shard.alock  # pin: a takeover swaps shard.alock mid-CS
            if local:
                alock.lock(p)
                flat = None
            else:
                flat = alock.lock(p, piggyback_reads=[
                    r for st in states
                    for r in (st.holder, st.expires, st.fence)
                ])
            try:
                if flat is None:
                    if local:
                        vals = [(self.mem.read(p, st.holder),
                                 self.mem.read(p, st.expires),
                                 self.mem.read(p, st.fence))
                                for st in states]
                    else:
                        out = self.mem.post_batch(p, [
                            wr for st in states
                            for wr in (("read", st.holder),
                                       ("read", st.expires),
                                       ("read", st.fence))
                        ])
                        vals = [tuple(out[3 * i:3 * i + 3])
                                for i in range(len(states))]
                else:
                    vals = [tuple(flat[3 * i:3 * i + 3])
                            for i in range(len(states))]
                plan = []  # (st, packed-as-read, release tuple, lease)
                for lease, st, (holder, (etok, readers, eexp), fence) in zip(
                        group, states, vals):
                    if (
                        holder == lease.holder_pid
                        and fence == lease.token
                        and _dec(readers) == 0
                        and not (etok == fence and eexp <= _FREE_AT)
                    ):
                        plan.append((st, (etok, readers, eexp),
                                     (lease.token, readers, _FREE_AT),
                                     lease))
                # Commit by CAS (the word is CAS-only — a CS-free join can
                # land between read and commit); one doorbell for the group.
                if plan:
                    if local:
                        won = [self.mem.cas(p, st.expires, packed, new)
                               == packed for st, packed, new, _l in plan]
                    else:
                        obs = self.mem.post_batch(p, [
                            ("cas", st.expires, packed, new)
                            for st, packed, new, _l in plan
                        ])
                        won = [o == packed
                               for o, (_s, packed, _n, _l) in zip(obs, plan)]
                    for (st, packed, _new, lease), ok in zip(plan, won):
                        if ok:
                            writes.append(("write", st.holder, _NO_HOLDER))
                            released += 1
                            if _infl(packed[1]):
                                handoffs.append((st, lease))
            finally:
                alock.unlock(p, piggyback=writes or None)
        finally:
            self._account(shard, p, snap, LeaseMode.EXCLUSIVE)
        for st, lease in handoffs:
            self._inflated_handoff(p, shard, st, lease.key, lease)
        return released

    def _release_group_shared(self, p: Process, shard: LockShard,
                              group: Sequence[Lease]) -> int:
        """Batched shared releases: one read doorbell + one CAS doorbell for
        the group's first round; CAS losers retry individually (rare — only
        same-key leases in one batch, or an outside racer)."""
        local = p.node == shard.home_host
        released = 0
        if local:
            for lease in group:
                st = self._key_state(shard, lease.key)
                if self._shared_release(p, shard, st, lease):
                    released += 1
            return released
        snap = p.counts.as_tuple()
        retry: List[Lease] = []
        done: List[Lease] = []
        try:
            now = self.clock()
            # The slot-ledger filter applies batch-wide: a decrement the
            # caller does not own (double release, consumed by an upgrade,
            # or a duplicate of an earlier batch entry) is never posted.
            owned: List[Lease] = []
            counted: Dict[Tuple[str, int], int] = {}
            for lease in group:
                if now >= lease.expires_at:
                    continue
                k = (lease.key, lease.token)
                counted[k] = counted.get(k, 0) + 1
                if counted[k] <= self._slot_count(p, lease.key, lease.token):
                    owned.append(lease)
            pending = [(l, self._key_state(shard, l.key)) for l in owned]
            if pending:
                packeds = self.mem.post_batch(
                    p, [("read", st.expires) for _, st in pending])
                wrs, metas = [], []
                for (lease, st), packed in zip(pending, packeds):
                    etok, readers, eexp = packed
                    dec, infl = _dec(readers), _infl(readers)
                    if etok != lease.token or dec <= 0:
                        continue  # generation moved on: nothing to release
                    new = (etok, _enc(dec - 1, infl),
                           eexp if dec > 1 else _FREE_AT)
                    wrs.append(("cas", st.expires, packed, new))
                    metas.append((lease, packed))
                outs = self.mem.post_batch(p, wrs) if wrs else []
                for (lease, packed), obs in zip(metas, outs):
                    if obs == packed:
                        done.append(lease)
                    else:
                        retry.append(lease)
        finally:
            self._account(shard, p, snap, LeaseMode.SHARED)
        if done:
            for lease in done:
                self._slot_consume(p, lease.key, lease.token)
            with shard._meta:
                shard.shared_releases += len(done)
            released += len(done)
        for lease in retry:
            st = self._key_state(shard, lease.key)
            if self._shared_release(p, shard, st, lease):
                released += 1
        return released

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> List[Dict]:
        """Per-shard snapshot: placement, grant counters, per-class OpCounts
        (total and per mode)."""
        out = []
        for shard in self.shards:
            with shard._meta:
                out.append({
                    "shard": shard.index,
                    "home_host": shard.home_host,
                    "keys": len(shard.keys),
                    "grants": shard.grants,
                    "rejects": shard.rejects,
                    "grants_shared": shard.grants_by_mode[LeaseMode.SHARED],
                    "grants_exclusive":
                        shard.grants_by_mode[LeaseMode.EXCLUSIVE],
                    "rejects_shared": shard.rejects_by_mode[LeaseMode.SHARED],
                    "rejects_exclusive":
                        shard.rejects_by_mode[LeaseMode.EXCLUSIVE],
                    "expirations": shard.expirations,
                    "fast_renews": shard.fast_renews,
                    "fast_releases": shard.fast_releases,
                    "shared_joins": shard.shared_joins,
                    "shared_renews": shard.shared_renews,
                    "shared_releases": shard.shared_releases,
                    "shared_remote_grants": shard.shared_remote_grants,
                    "shared_acquire_rcas": shard.shared_acquire_rcas,
                    "upgrades": shard.upgrades,
                    "downgrades": shard.downgrades,
                    "intent_blocks": shard.intent_blocks,
                    "repairs": shard.repairs,
                    "reclaims": shard.reclaims,
                    "reclaim_fast": shard.reclaim_fast,
                    "reclaim_slow": shard.reclaim_slow,
                    "reclaim_shared": shard.reclaim_shared,
                    "reclaim_rejects": shard.reclaim_rejects,
                    "orphan_probes": shard.orphan_probes,
                    "orphan_adopts": shard.orphan_adopts,
                    "reconstructions": shard.reconstructions,
                    "reconstruct_resets": shard.reconstruct_resets,
                    "epoch": shard.epoch,
                    "takeovers": shard.takeovers,
                    "takeover_refusals": shard.takeover_refusals,
                    "takeover_aborts": shard.takeover_aborts,
                    "epoch_aborts": shard.epoch_aborts,
                    "rehomed_keys": shard.rehomed_keys,
                    "inflations": shard.inflations,
                    "deflations": shard.deflations,
                    "queue_enqueues": shard.queue_enqueues,
                    "queue_grants": shard.queue_grants,
                    "queue_handoffs": shard.queue_handoffs,
                    "queue_bypasses": shard.queue_bypasses,
                    "contended_keys": len(shard.key_retries),
                    "blocked_attempts": sum(shard.key_retries.values()),
                    # Overload-protection counters: the shard-side
                    # (shed/deadline/hedge) half; the breaker/budget half
                    # lives on table.overload.report().
                    "sheds": shard.sheds,
                    "hedges": shard.hedges,
                    "deadline_exceeded": shard.deadline_exceeded,
                    # Optimistic-read (seqlock) counters.
                    "opt_reads": shard.opt_reads,
                    "opt_read_retries": shard.opt_read_retries,
                    "opt_read_fallbacks": shard.opt_read_fallbacks,
                    "opt_read_fwd": shard.opt_read_fwd,
                    "publishes": shard.publishes,
                    "timeouts": (shard.stats[LOCAL].timeouts
                                 + shard.stats[REMOTE].timeouts),
                    "fabric_retries": (shard.stats[LOCAL].retries
                                       + shard.stats[REMOTE].retries),
                    "local": shard.stats[LOCAL].snapshot(),
                    "remote": shard.stats[REMOTE].snapshot(),
                    "shared_local":
                        shard.mode_stats[(LeaseMode.SHARED, LOCAL)].snapshot(),
                    "shared_remote":
                        shard.mode_stats[(LeaseMode.SHARED, REMOTE)].snapshot(),
                    "exclusive_local":
                        shard.mode_stats[(LeaseMode.EXCLUSIVE, LOCAL)].snapshot(),
                    "exclusive_remote":
                        shard.mode_stats[(LeaseMode.EXCLUSIVE, REMOTE)].snapshot(),
                })
        return out

    def queued(self, p: Process, key: str) -> bool:
        """Is ``p`` parked in ``key``'s inflated-mode queue?  Host-side
        metadata check, zero simulated ops — clients use it to pick their
        retry cadence: a queued waiter's poll is ONE local read (the MCS
        local spin), so it polls fine-grained instead of exponentially
        backing off like a CAS-word contender."""
        ws = self._waits.get(p.pid, {}).get(key)
        if ws is None:
            return False
        st = self.shards[self.shard_of(key)].keys.get(key)
        return st is not None and st.infl is ws[0]

    def hot_keys(self, k: int = 10) -> List[List]:
        """Top-``k`` keys by blocked-attempt count across all shards, as
        ``[key, blocked_attempts, op_timeouts, fabric_retries]`` rows
        (count-desc, then key — a total order, so the report is
        deterministic).  The two fabric columns surface WHERE the op
        timeouts and fabric-level retry rounds (already counted in the
        per-class OpCounts) actually landed — a congested home's keys show
        fabric pain even when they are not CAS-contended."""
        merged: Dict[str, int] = {}
        t_merged: Dict[str, int] = {}
        r_merged: Dict[str, int] = {}
        for shard in self.shards:
            with shard._meta:
                for key, n in shard.key_retries.items():
                    merged[key] = merged.get(key, 0) + n
                for key, n in shard.key_timeouts.items():
                    t_merged[key] = t_merged.get(key, 0) + n
                    merged.setdefault(key, 0)
                for key, n in shard.key_fab_retries.items():
                    r_merged[key] = r_merged.get(key, 0) + n
                    merged.setdefault(key, 0)
        ranked = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
        return [[key, n, t_merged.get(key, 0), r_merged.get(key, 0)]
                for key, n in ranked[:k]]

    def inflation_log(self) -> List[List]:
        """The inflate/deflate event log, in decision order: rows of
        ``[t, action, key, token, reason]``.  Same-seed sim runs produce
        byte-identical logs (the CI determinism gate relies on it)."""
        with self._infl_guard:
            return [list(row) for row in self._infl_events]

    def class_totals(self) -> Dict[int, OpCounts]:
        """Aggregate per-class OpCounts across all shards."""
        totals = {LOCAL: OpCounts(), REMOTE: OpCounts()}
        for shard in self.shards:
            with shard._meta:
                for cls in (LOCAL, REMOTE):
                    totals[cls] = totals[cls] + shard.stats[cls]
        return totals

    def mode_class_totals(self) -> Dict[LeaseMode, Dict[int, OpCounts]]:
        """Aggregate per-(mode, class) OpCounts across all shards."""
        totals = {m: {LOCAL: OpCounts(), REMOTE: OpCounts()}
                  for m in LeaseMode}
        for shard in self.shards:
            with shard._meta:
                for m in LeaseMode:
                    for cls in (LOCAL, REMOTE):
                        totals[m][cls] = (totals[m][cls]
                                          + shard.mode_stats[(m, cls)])
        return totals
