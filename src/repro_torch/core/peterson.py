"""Modified Peterson's lock (paper Algorithm 1).

A two-party starvation-free mutual-exclusion protocol between the *local*
class (cid 0) and the *remote* class (cid 1), built only from read/write
registers — the greatest common denominator under operation asymmetry, since
local and remote RMW are not mutually atomic (Table 1).

Differences from textbook Peterson:

* the "interested" flags ARE the embedded cohort locks' tail registers
  (``cohort[id].qIsLocked()`` replaces ``flag[other]``) — acquiring the cohort
  lock *is* the announcement of interest;
* ``p_reacquire`` (Algorithm 1 line 12) releases-and-reacquires by setting
  ``victim := self`` and re-waiting, used by the budget mechanism to bound
  consecutive same-class hand-offs (fairness).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .memory import NULLPTR, AsymmetricMemory, Process, Register
from .mcs import BudgetedMCSLock


class ModifiedPetersonLock:
    """Paper Algorithm 1, parameterised over the two cohort locks."""

    def __init__(
        self,
        mem: AsymmetricMemory,
        victim: Register,
        cohorts: Sequence[BudgetedMCSLock],
    ):
        assert len(cohorts) == 2
        self.mem = mem
        self.victim = victim
        self.cohorts = cohorts

    def acquire(self, p: Process, cid: int,
                piggyback_reads: Optional[Sequence[Register]] = None,
                ) -> Optional[List]:
        """Algorithm 1 lines 6-7 (the ``isLeader`` branch of ``pLock``).

        ``piggyback_reads`` (remote callers only; registers on the victim's
        node) are chained into the same doorbell as the Peterson engagement:
        ``[write victim, read other-tail, read r0, read r1, ...]``.  WR lists
        execute in order, so if the other cohort's tail reads ``NULLPTR`` the
        caller enters the critical section *immediately* — and the
        piggybacked values are then valid CS reads: an MCS holder keeps its
        cohort tail non-null for its whole critical section (including
        intra-cohort hand-offs), so a null tail proves no opposite-class
        holder was in (or could linearize into) the CS before our victim
        write, which any later-arriving leader must lose to.  Returns the
        read values on that uncontended fast entry, else ``None`` — the
        caller must re-read inside the critical section (the values may have
        been read while an opposite-class holder was still active).
        """
        other = 1 - cid
        tail = self.cohorts[other].tail
        extra = [("read", r) for r in piggyback_reads or ()]
        if not p.is_local_to(self.victim):
            # Remote leader: engage with ONE posting — victim write, the
            # other cohort's interested flag, and any piggybacked reads.
            out = self.mem.post_batch(p, [
                ("write", self.victim, cid), ("read", tail), *extra,
            ])
            if out[1] is NULLPTR:
                return out[2:] if piggyback_reads else None  # fast entry
            # Contended: wait, re-reading flag+victim (and the piggyback) in
            # one posting per spin.  Whichever exit fires, the *same*
            # posting's piggybacked reads are valid CS reads: a null tail
            # proves the opposite cohort fully drained (a holder keeps its
            # tail non-null for its whole CS, writes flushed before the
            # drain), and ``victim != cid`` proves a fresh opposite-class
            # leader wrote victim after us — a leader only engages on an
            # *empty* cohort (no holder inside) and now parks until we
            # release.  Same-class holders are excluded by our own cohort
            # MCS throughout.
            while True:
                out = self.mem.post_batch(p, [
                    ("read", tail), ("read", self.victim), *extra,
                ])
                if out[0] is NULLPTR or out[1] != cid:
                    return out[2:] if piggyback_reads else None
                self.mem.yield_point()
        self.mem.auto_write(p, self.victim, cid)
        self.mem.fence(p)
        while (
            self.cohorts[other].q_is_locked(p)
            and self.mem.auto_read(p, self.victim) == cid
        ):
            self.mem.yield_point()
        return None

    def reacquire(self, p: Process, cid: int) -> None:
        """``pReacquire`` (Algorithm 1 lines 12-16): yield then re-wait.

        Setting ``victim := cid`` lets a waiting opposite-class leader through;
        if none is waiting the caller re-enters immediately.  Identical wait
        condition to :meth:`acquire` — the paper folds both into one routine in
        the PlusCal spec (``AcquireGlobal``).
        """
        self.acquire(p, cid)
