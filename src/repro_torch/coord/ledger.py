"""Persistent lease ledgers: crash-restart re-entry for lease holders.

A lease holder that crashes today wedges its keys for a full TTL — the
leases are correct (fencing keeps the zombie out) but the *restarted*
process rejoins amnesiac and waits the wedge out like a stranger.  This
module gives each client a durable, append-only **lease ledger**: a record
per protocol transition (intent, grant, renew, release), replayable into
the set of leases the client plausibly still holds.  A restarted client
replays its ledger and *reclaims* each still-valid lease with a
fencing-checked CAS (see :meth:`~repro_torch.coord.ShardedLockTable.reclaim`)
instead of waiting out the TTL — recovery cost proportional to the leases
in flight at the crash, not to the keyspace (the Dhoked & Mittal
"adaptive to failures" shape, transplanted to leases).

Write-ahead discipline
----------------------

:class:`RecoverableClient` writes an ``intent`` record *before* the grant
CAS and a ``grant`` record *after* it, so a crash in either window leaves
a recoverable trail:

* crash after intent, before the CAS: restart finds a **dangling intent**
  and probes the word (:meth:`~repro_torch.coord.ShardedLockTable.reclaim_orphan`)
  — if the grant never happened the probe finds a stranger and resolves
  the intent; nothing is leaked.
* crash after the CAS, before the grant record: the lease exists under a
  dead pid with no ledger witness.  The dangling intent still names the
  key, and the ``session`` records name every pid this client ever ran
  as — the orphan probe recognises the word's holder as one of its own
  dead incarnations (pids are never reused) and adopts the grant.

Replay is a pure fold over the records: calling it twice gives the same
view, and re-appending the most recent record (the crash-retry window —
a client that died before learning its append landed re-appends on
restart) leaves the view unchanged.

Durability is modeled, not simulated: records append to an in-memory list
(the sim's "persistent disk"), with JSONL dump/load for real processes —
:class:`LedgerStore` keys ledgers by client name so a *restarted* client
(new pid, same name) finds its predecessor's records, which is exactly the
crash model.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import Process

from .table import Lease, LeaseMode, ShardedLockTable

__all__ = ["LedgerRecord", "LedgerView", "LeaseLedger", "LedgerStore",
           "RecoverableClient"]

# Record ops, in the protocol's vocabulary:
#   session — a (re)start: names the pid this client now runs as.
#   intent  — write-ahead marker, appended BEFORE the grant CAS.
#   grant   — a lease was granted (or adopted by reclaim/orphan probe).
#   renew   — the lease's witness moved to a later expiry.
#   release — the lease was released (tombstone).
#   lost    — restart observed the lease dead/fenced-out (tombstone).
#   resolve — an intent's outcome is settled (granted, rejected, or probed).
_OPS = ("session", "intent", "grant", "reclaim", "renew", "release", "lost",
        "resolve")


@dataclass(frozen=True)
class LedgerRecord:
    """One append-only ledger entry.  ``seq`` orders records within one
    ledger; lease-carrying ops snapshot the full fast-path witness
    (token, expires_at) so replay can hand reclaim a CAS-ready lease."""

    seq: int
    op: str
    key: str = ""
    shard: int = -1
    token: int = 0
    mode: int = int(LeaseMode.EXCLUSIVE)
    expires_at: float = 0.0
    ttl: float = 0.0
    pid: int = -1
    # The word's inflation mode bit at record time (int for JSONL
    # stability): reclaim's fast-path witness must encode it or a reclaim
    # of an inflated-mode grant would never match the word.
    inflated: int = 0

    def as_lease(self) -> Lease:
        return Lease(self.key, self.shard, self.pid, self.token,
                     self.expires_at, self.ttl, LeaseMode(self.mode),
                     bool(self.inflated))


@dataclass
class LedgerView:
    """The replayed state: what this client plausibly still holds.

    ``live`` maps key → the latest unreleased grant/renew record;
    ``intents`` maps key → a dangling intent (written, never resolved);
    ``pids`` lists every pid the client has run as, oldest first.
    """

    live: Dict[str, LedgerRecord]
    intents: Dict[str, LedgerRecord]
    pids: List[int]


class LeaseLedger:
    """Append-only, replayable record list for ONE client identity."""

    def __init__(self, name: str):
        self.name = name
        self.records: List[LedgerRecord] = []
        self._seq = 0

    def append(self, op: str, *, key: str = "", shard: int = -1,
               token: int = 0, mode: int = int(LeaseMode.EXCLUSIVE),
               expires_at: float = 0.0, ttl: float = 0.0,
               pid: int = -1, inflated: int = 0) -> LedgerRecord:
        if op not in _OPS:
            raise ValueError(f"unknown ledger op {op!r}")
        rec = LedgerRecord(self._seq, op, key, shard, token, int(mode),
                           expires_at, ttl, pid, int(inflated))
        self._seq += 1
        self.records.append(rec)
        return rec

    def append_lease(self, op: str, lease: Lease) -> LedgerRecord:
        return self.append(op, key=lease.key, shard=lease.shard,
                           token=lease.token, mode=int(lease.mode),
                           expires_at=lease.expires_at, ttl=lease.ttl,
                           pid=lease.holder_pid,
                           inflated=int(lease.inflated))

    # -------------------------------------------------------------- replay
    def replay(self) -> LedgerView:
        """Pure fold of the records into the client's plausible holdings."""
        return replay_records(self.records)

    # --------------------------------------------------------- persistence
    def dump_jsonl(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for rec in self.records:
                f.write(json.dumps(asdict(rec), sort_keys=True) + "\n")

    @classmethod
    def load_jsonl(cls, path: str, name: Optional[str] = None) -> "LeaseLedger":
        """Load a dumped ledger, tolerating a **torn tail**.

        A crash mid-append leaves the final line truncated (or a final
        newline missing entirely) — the exact artifact this module's crash
        model produces on a real disk.  A corrupt LAST non-empty line is
        therefore truncated away with a warning: the write-ahead discipline
        already covers the loss (the record that tore was the one being
        written at the crash; its intent precedes it, so restart's orphan
        probe settles the key).  Corruption anywhere *before* the tail has
        no such excuse — an append-only file does not tear in the middle —
        and raises ``ValueError``: that file is damaged, not torn.
        """
        led = cls(name or path)
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # Indices of non-empty lines; only the LAST one may be torn.
        body = [(i, ln) for i, ln in enumerate(lines) if ln.strip()]
        for pos, (i, line) in enumerate(body):
            try:
                rec = LedgerRecord(**json.loads(line))
            except (ValueError, TypeError) as exc:
                # json decode errors are ValueError; unexpected/missing
                # fields surface as TypeError from the dataclass ctor.
                if pos == len(body) - 1:
                    warnings.warn(
                        f"{path}: torn final ledger record (line {i + 1}) "
                        f"truncated: {exc}", RuntimeWarning, stacklevel=2)
                    break
                raise ValueError(
                    f"{path}: corrupt ledger record mid-file "
                    f"(line {i + 1}): {exc}") from exc
            led.records.append(rec)
        led._seq = (led.records[-1].seq + 1) if led.records else 0
        return led


def replay_records(records: Iterable[LedgerRecord]) -> LedgerView:
    """The replay fold, usable on any record stream (e.g. a merged stream
    from several surviving ledgers during shard reconstruction).

    Idempotent: a pure function of the record sequence, and re-appending
    the most recent record leaves the view unchanged (grant/renew/session
    overwrite with equal content; release/lost/resolve tombstone an
    already-tombstoned key harmlessly).
    """
    live: Dict[str, LedgerRecord] = {}
    intents: Dict[str, LedgerRecord] = {}
    pids: List[int] = []
    for rec in records:
        if rec.op == "session":
            if not pids or pids[-1] != rec.pid:
                pids.append(rec.pid)
        elif rec.op == "intent":
            intents[rec.key] = rec
        elif rec.op in ("grant", "reclaim"):
            live[rec.key] = rec
            intents.pop(rec.key, None)
        elif rec.op == "renew":
            cur = live.get(rec.key)
            # A renewal only refreshes the grant it belongs to; a renew
            # record for an unknown/other-token grant is ignored (tolerant
            # of records lost in the crash windows).
            if cur is not None and cur.token == rec.token:
                live[rec.key] = rec
        elif rec.op in ("release", "lost"):
            cur = live.get(rec.key)
            if cur is not None and cur.token == rec.token:
                del live[rec.key]
            intents.pop(rec.key, None)
        elif rec.op == "resolve":
            intents.pop(rec.key, None)
    return LedgerView(live=live, intents=intents, pids=pids)


class LedgerStore:
    """Ledgers keyed by *client name* — the identity that survives a crash.

    A restarted client asks the store for its name and gets its
    predecessor's ledger back; that handoff IS the modeled durability.
    """

    def __init__(self) -> None:
        self._ledgers: Dict[str, LeaseLedger] = {}

    def ledger(self, name: str) -> LeaseLedger:
        led = self._ledgers.get(name)
        if led is None:
            led = self._ledgers[name] = LeaseLedger(name)
        return led

    def names(self) -> List[str]:
        return sorted(self._ledgers)

    def all_records(self) -> List[LedgerRecord]:
        """Every surviving ledger's records (reconstruction input)."""
        out: List[LedgerRecord] = []
        for name in self.names():
            out.extend(self._ledgers[name].records)
        return out


class RecoverableClient:
    """A lease client that writes the ledger protocol and can restart.

    Wraps a :class:`~repro_torch.coord.ShardedLockTable` (or anything exposing
    its lease API plus ``reclaim``/``reclaim_orphan``/``_crash_point`` —
    a :class:`~repro_torch.coord.CoordinationService` passes its ``.table``).
    All lease operations go through here so every transition lands in the
    ledger; :meth:`restart` is the crash-recovery entry point.
    """

    def __init__(self, table: ShardedLockTable, p: Process,
                 ledger: LeaseLedger):
        self.table = getattr(table, "table", table)
        self.p = p
        self.ledger = ledger
        self.ledger.append("session", pid=p.pid)

    # ------------------------------------------------------------- helpers
    def _cp(self, label: str) -> None:
        self.table._crash_point(label, self.p)

    # ------------------------------------------------------------ lease API
    def try_acquire(self, key: str, ttl: float,
                    mode: LeaseMode = LeaseMode.EXCLUSIVE) -> Optional[Lease]:
        self.ledger.append("intent", key=key, mode=int(mode), ttl=ttl,
                           pid=self.p.pid)
        self._cp("ledger.post_intent")
        lease = self.table.try_acquire(self.p, key, ttl, mode=mode)
        if lease is None:
            self.ledger.append("resolve", key=key)
            return None
        self._cp("grant.pre_ledger")
        self.ledger.append_lease("grant", lease)
        return lease

    def acquire_batch(self, keys: Sequence[str], ttl: float,
                      timeout: Optional[float] = None,
                      mode: LeaseMode = LeaseMode.EXCLUSIVE) -> List[Lease]:
        ordered = self.table.batch_order(keys)
        for key in ordered:
            self.ledger.append("intent", key=key, mode=int(mode), ttl=ttl,
                               pid=self.p.pid)
        self._cp("ledger.post_intent")
        try:
            leases = self.table.acquire_batch(self.p, ordered, ttl,
                                              timeout=timeout, mode=mode)
        except TimeoutError:
            for key in ordered:  # the table released everything it held
                self.ledger.append("resolve", key=key)
            raise
        self._cp("grant.pre_ledger")
        for lease in leases:
            self.ledger.append_lease("grant", lease)
        return leases

    def renew(self, lease: Lease,
              ttl: Optional[float] = None) -> Optional[Lease]:
        self._cp("renew.pre_cas")
        renewed = self.table.renew(self.p, lease, ttl)
        if renewed is None:
            self.ledger.append_lease("lost", lease)
            return None
        self._cp("renew.pre_ledger")
        self.ledger.append_lease("renew", renewed)
        return renewed

    def release(self, lease: Lease) -> bool:
        self._cp("release.pre_cas")
        ok = self.table.release(self.p, lease)
        self._cp("release.pre_ledger")
        # Tombstone either way: a failed release means the lease is already
        # dead (expired/fenced), and the view should stop claiming it.
        self.ledger.append_lease("release", lease)
        return ok

    def upgrade(self, lease: Lease,
                ttl: Optional[float] = None) -> Optional[Lease]:
        up = self.table.upgrade(self.p, lease, ttl)
        if up is not None:
            self.ledger.append_lease("release", lease)  # slot consumed
            self.ledger.append_lease("grant", up)
        return up

    # ------------------------------------------------------------- restart
    def adopt_process(self, p: Process) -> None:
        """Rebind to a new incarnation WITHOUT recovery (the amnesiac
        baseline the benchmarks compare against)."""
        self.p = p
        self.ledger.append("session", pid=p.pid)

    def restart(self, p: Process) -> List[Lease]:
        """Crash-restart re-entry: replay the ledger, reclaim what lives.

        Three passes, each bounded by what was *in flight* at the crash:

        1. every ``live`` record → :meth:`ShardedLockTable.reclaim` (fast
           fencing-checked CAS; still-valid leases come back, expired or
           fenced-out ones are tombstoned);
        2. every dangling ``intent`` → the orphan probe, which adopts
           grants that committed but were never recorded (the word's
           holder is one of our dead pids);
        3. a fresh ``session`` record so the next incarnation knows this
           pid too is fair game for its own orphan probe.

        Returns the reclaimed leases, ledgered as ``reclaim`` records.
        """
        view = self.ledger.replay()
        dead = [pid for pid in view.pids if pid != p.pid]
        self.p = p
        self.ledger.append("session", pid=p.pid)
        out: List[Lease] = []
        for key in sorted(view.live):
            lease = view.live[key].as_lease()
            got = self.table.reclaim(p, lease)
            if got is not None:
                self.ledger.append_lease("reclaim", got)
                out.append(got)
            else:
                self.ledger.append_lease("lost", lease)
        for key in sorted(view.intents):
            rec = view.intents[key]
            got = None
            if rec.mode == int(LeaseMode.EXCLUSIVE):
                got = self.table.reclaim_orphan(p, key, dead,
                                                rec.ttl or lease_ttl(rec))
            # SHARED intents are not probed: the packed word's reader count
            # is anonymous, so a dead reader's maybe-join cannot be told
            # apart from a stranger's — the slot (if any) expires with its
            # horizon and harms no one (readers fence nothing downstream).
            if got is not None:
                self.ledger.append_lease("reclaim", got)
                out.append(got)
            self.ledger.append("resolve", key=key)
        return out


def lease_ttl(rec: LedgerRecord) -> float:
    """A defensive fallback TTL for records written before ttl was known."""
    return rec.ttl if rec.ttl > 0 else 1.0
