"""Deterministic fault injection: labeled crash points for the lease stack.

Recovery code is only as trustworthy as the crashes it has survived, and
real crashes land in the narrowest windows — after a grant CAS commits but
before the client's ledger records it, between two shard groups of a batch,
while a writer's drain barrier is armed.  This module makes those windows
*first-class*: the lock table and the recoverable client wrapper call
:meth:`FaultInjector.crash_point` at each labeled window, and an armed
injector raises :class:`ClientCrash` there — synchronously, mid-protocol,
exactly where a kill -9 would land.

Two trigger styles, both deterministic:

* :meth:`FaultInjector.at` — "crash the *nth* arrival at this label"
  (optionally filtered to one pid).  The crash-point matrix test arms one
  label per case and proves recovery from every window.
* :meth:`FaultInjector.seeded` — a seeded Bernoulli draw per arrival, for
  crash *storms*: same seed ⇒ the same crashes at the same arrivals, so a
  CI rerun is byte-identical.

Every firing is appended to :attr:`FaultInjector.fired` (label, pid,
arrival index) — the determinism gate diffs this log across same-seed runs.

Crash points sit **outside** ALock critical sections by design: a lease
holder may die at any of them and the shard stays serviceable (leases
expire; the CS itself is never wedged).  The catalog is
:data:`CRASH_POINTS`; ``docs/recovery.md`` documents what each window
leaves behind and how restart recovery repairs it.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

__all__ = ["CRASH_POINTS", "FABRIC_POINTS", "ClientCrash", "FaultInjector"]


# The labeled windows, in protocol order.  Each names the state a crash
# there abandons (see docs/recovery.md for the per-window recovery story):
#
#   ledger.post_intent — the write-ahead intent is durable, the grant CAS
#       has not run: restart finds a dangling intent and probes the word.
#   grant.pre_ledger   — the grant CAS committed, the grant record did not:
#       the lease exists under a dead pid with no ledger witness; restart's
#       orphan probe adopts it via the holder register + fence check.
#   renew.pre_cas      — a renewal was requested but never reached the word.
#   renew.pre_ledger   — the renewal CAS landed, the ledger still holds the
#       older witness: reclaim's fast CAS misses and the slow path
#       revalidates against the (fresher) word.
#   release.pre_cas    — a release never reached the word: the ledger says
#       held, the word agrees — reclaim succeeds, the lease outlives the
#       crash (safe: it was never released).
#   release.pre_ledger — the release CAS landed, the tombstone did not: the
#       ledger over-claims and reclaim fails cleanly (fence/word mismatch).
#   batch.mid          — between two shard groups of acquire_batch: a prefix
#       of the batch is held by a dead pid, unrecorded; dangling intents
#       drive the orphan probe, key by key.
#   drain.mid          — a writer died right after arming a reader-cohort
#       drain barrier: the barrier lapses on its own (it is a deadline).
#   upgrade.mid        — an upgrader died after arming the drain barrier
#       mid-upgrade; its shared slot is still counted and reclaimable.
#   inflate.mid        — the waiter that swung a key into queued (inflated)
#       mode died right after the mode CAS: the key stays inflated with a
#       queue the dead pid never joined — it serves through the inflated
#       path and deflates when cool (no fencing state was abandoned).
#   deflate.mid        — an inflated-mode holder died after its release CAS
#       but before passing the queue on: its cohort's head never gets the
#       handoff, distrusts the queue after the staleness deadline, and
#       bypasses to the word (the bypass grant deflates the key).
CRASH_POINTS = (
    "ledger.post_intent",
    "grant.pre_ledger",
    "renew.pre_cas",
    "renew.pre_ledger",
    "release.pre_cas",
    "release.pre_ledger",
    "batch.mid",
    "drain.mid",
    "upgrade.mid",
    "inflate.mid",
    "deflate.mid",
)

# Fabric-side labeled points: message-loss windows rather than process-death
# windows.  They arm through the same one-shot / seeded machinery but are
# *decisions*, not crashes — the fabric asks :meth:`FaultInjector.
# fabric_point` whether to lose/duplicate/delay a specific posting, and the
# poster survives (timeout + bounded retry).  This is what lets the crash
# matrix cross host-crash cells with message-loss cells: one injector arms
# ``release.pre_cas`` AND ``fabric.drop`` and both land deterministically.
#
#   fabric.drop  — the posting is lost; the poster discovers it at the op
#       timeout and reposts on the seeded backoff schedule.
#   fabric.dup   — the posting is delivered twice (at-least-once delivery);
#       reads/writes are idempotent and a duplicated CAS observes its own
#       swap, so the CAS-only lease word absorbs it.
#   fabric.delay — the posting is delivered late (extra latency, no loss).
#   fabric.congest — the destination host is congested for this posting: it
#       is delivered, but only after one full congestion quantum of queueing
#       delay, as if the host's receive queue were at capacity.  Forces the
#       overload machinery (deadline sheds, breaker trips, hedged probes)
#       onto a specific posting without needing a whole storm.
FABRIC_POINTS = (
    "fabric.drop",
    "fabric.dup",
    "fabric.delay",
    "fabric.congest",
)

_ALL_POINTS = frozenset(CRASH_POINTS) | frozenset(FABRIC_POINTS)


class ClientCrash(Exception):
    """The injected process death.  Raised at a crash point (synchronously,
    by an armed :class:`FaultInjector`) or thrown into a sim task by
    :meth:`~repro_torch.sim.SimEngine.kill` (asynchronously, at the task's next
    dispatch).  Client code treats it the way a supervisor treats a dead
    worker: abandon all in-memory state, restart, replay the ledger."""

    def __init__(self, label: str, pid: Optional[int] = None):
        super().__init__(f"injected crash at {label!r}"
                         + (f" (pid {pid})" if pid is not None else ""))
        self.label = label
        self.pid = pid


class FaultInjector:
    """Arms crash points with deterministic triggers.

    Thread-compatible in the same sense as the shard telemetry: arrivals
    are counted under no lock (sim steps are atomic; the threaded stress
    tests arm pid-filtered one-shots, which fire exactly once per filter
    regardless of interleaving — the ``nth`` comparison is on the filter's
    own monotone counter).
    """

    def __init__(self) -> None:
        # label -> total arrivals observed (armed or not).
        self.hits: Dict[str, int] = {}
        # Firing log: (label, pid, arrival index at that label).
        self.fired: List[Tuple[str, int, int]] = []
        # One-shot triggers: (label, pid-or-None) -> arrival number to kill.
        self._oneshots: Dict[Tuple[str, Optional[int]], int] = {}
        # Per-filter arrival counters (pid-filtered triggers count their own
        # arrivals; the global `hits` counts everyone's).
        self._filter_hits: Dict[Tuple[str, Optional[int]], int] = {}
        self._rng: Optional[random.Random] = None
        self._prob = 0.0
        self._labels: Optional[frozenset] = None

    # ------------------------------------------------------------- arming
    def at(self, label: str, nth: int = 1,
           pid: Optional[int] = None) -> "FaultInjector":
        """Crash the ``nth`` arrival at ``label`` (1-based), optionally only
        counting arrivals by ``pid``.  Returns self for chaining."""
        if label not in _ALL_POINTS:
            raise ValueError(f"unknown crash point {label!r}")
        if nth < 1:
            raise ValueError("nth is 1-based")
        self._oneshots[(label, pid)] = nth
        return self

    @classmethod
    def seeded(cls, seed: int, prob: float,
               labels: Optional[Tuple[str, ...]] = None) -> "FaultInjector":
        """A crash storm: every arrival at an armed label dies with
        probability ``prob``, drawn from a dedicated seeded stream (the
        schedule depends only on ``seed`` and the arrival order, which the
        sim engine already makes deterministic)."""
        fi = cls()
        fi._rng = random.Random(0x9E3779B1 * (seed + 1))
        fi._prob = float(prob)
        if labels is not None:
            for lab in labels:
                if lab not in _ALL_POINTS:
                    raise ValueError(f"unknown crash point {lab!r}")
            fi._labels = frozenset(labels)
        return fi

    # ------------------------------------------------------------- firing
    def crash_point(self, label: str, pid: int) -> None:
        """Called by instrumented code at each labeled window; raises
        :class:`ClientCrash` when a trigger matches, else returns."""
        n = self.hits.get(label, 0) + 1
        self.hits[label] = n
        for filt in ((label, None), (label, pid)):
            want = self._oneshots.get(filt)
            if want is None:
                continue
            fn = self._filter_hits.get(filt, 0) + 1
            self._filter_hits[filt] = fn
            if fn == want:
                del self._oneshots[filt]
                self.fired.append((label, pid, n))
                raise ClientCrash(label, pid)
        if (self._rng is not None and self._prob > 0.0
                and (self._labels is None or label in self._labels)
                and self._rng.random() < self._prob):
            self.fired.append((label, pid, n))
            raise ClientCrash(label, pid)

    def fabric_point(self, label: str, pid: int) -> bool:
        """Called by a lossy fabric for each remote posting; returns whether
        the labeled fault (``fabric.drop`` / ``fabric.dup`` /
        ``fabric.delay``) fires on this posting.

        Same counters and ``fired`` log as :meth:`crash_point`, but the
        trigger is a *decision* — the posting is lost/duplicated/delayed and
        the poster rides its retry schedule instead of dying.  Seeded storms
        only reach fabric points when their ``labels`` name them explicitly:
        an unscoped storm (``labels=None``) keeps its historical meaning of
        "crash storm over the crash points" and never eats postings.
        """
        n = self.hits.get(label, 0) + 1
        self.hits[label] = n
        for filt in ((label, None), (label, pid)):
            want = self._oneshots.get(filt)
            if want is None:
                continue
            fn = self._filter_hits.get(filt, 0) + 1
            self._filter_hits[filt] = fn
            if fn == want:
                del self._oneshots[filt]
                self.fired.append((label, pid, n))
                return True
        if (self._rng is not None and self._prob > 0.0
                and self._labels is not None and label in self._labels
                and self._rng.random() < self._prob):
            self.fired.append((label, pid, n))
            return True
        return False
