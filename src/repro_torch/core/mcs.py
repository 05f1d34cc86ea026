"""Budgeted MCS queue lock (paper Algorithm 2).

One instance per *class* (local / remote).  The queue tail register lives on
the lock's home node and **doubles as the Peterson "interested" flag** for its
class (the paper's ``cohort[2]`` array).  Each process owns a remotely
accessible descriptor ``{budget, next}`` residing in its *own* node's memory
partition, so after enqueueing a process spins **locally** — the paper's key
property that removes remote spinning and its network traffic.

Operation costs (verified by ``benchmarks/lock_ops.py``):

* lone remote acquire:   1 rCAS
* queued remote acquire: 1 rCAS + 1 rWrite (link), then local spinning only
* remote release:        ≤ 1 rCAS + 1 rWrite
* any local-class call:  0 RDMA operations (auto-dispatch resolves every
  access to the local class's registers as a machine-local op)

The ``budget`` (Dice et al.'s lock-cohorting bound) caps consecutive same-class
hand-offs: a process handed a budget of 0 must call ``p_reacquire`` on the
global (Peterson) lock before entering, yielding to the other class if it is
waiting — this is what makes the combined primitive fair.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .memory import NULLPTR, AsymmetricMemory, Process, Register


class _Descriptor:
    """Remotely-accessible MCS descriptor: two registers on the owner's node."""

    __slots__ = ("budget", "next")

    def __init__(self, budget: Register, nxt: Register):
        self.budget = budget
        self.next = nxt


class BudgetedMCSLock:
    """Paper Algorithm 2 — budgeted MCS queue lock over asymmetric memory.

    ``p_reacquire`` is the hook into the enclosing modified Peterson's lock
    (Algorithm 1 line 12); it is injected by :class:`repro_torch.core.alock.ALock`
    after construction to break the circular dependency, mirroring how the
    paper embeds the cohort lock *inside* the global lock.
    """

    def __init__(
        self,
        mem: AsymmetricMemory,
        tail: Register,
        init_budget: int,
        name: str,
    ):
        if init_budget <= 0:
            raise ValueError("InitialBudget must be > 0 (PlusCal ASSUME)")
        self.mem = mem
        self.tail = tail  # == cohort[cid]: non-null ⇔ class is "interested"
        self.init_budget = init_budget
        self.name = name
        self.p_reacquire: Optional[Callable[[Process], None]] = None
        self._descs: Dict[int, _Descriptor] = {}
        self._desc_guard = __import__("threading").Lock()

    # ------------------------------------------------------------ descriptors
    def _desc(self, p: Process) -> _Descriptor:
        """The calling process's own descriptor (allocated on its node)."""
        d = self._descs.get(p.pid)
        if d is None:
            with self._desc_guard:
                d = self._descs.get(p.pid)
                if d is None:
                    prefix = f"{self.name}.desc.p{p.pid}"
                    d = _Descriptor(
                        budget=self.mem.alloc(p.node, f"{prefix}.budget", -1),
                        nxt=self.mem.alloc(p.node, f"{prefix}.next", NULLPTR),
                    )
                    self._descs[p.pid] = d
        return d

    def _desc_of(self, handle: Any) -> _Descriptor:
        """Dereference a descriptor handle found in shared memory."""
        return self._descs[handle]

    # -------------------------------------------------------------------- API
    def q_lock(self, p: Process) -> bool:
        """Acquire the cohort lock.

        Returns ``True`` iff the queue was empty at the outset — the caller is
        the class *leader* and must engage the global Peterson protocol
        (Algorithm 1 line 5).  ``False`` means the global lock was passed to
        us by a cohort member (possibly after a budget-forced reacquire).
        """
        mem = self.mem
        d = self._desc(p)
        # PlusCal c1: descriptor := [budget |-> -1, next |-> 0].  Setting
        # budget=-1 *before* publishing the descriptor avoids a lost hand-off
        # (Algorithm 2 writes -1 after the CAS but before linking; equivalent
        # because the predecessor cannot find us until the link rWrite).
        mem.auto_write(p, d.budget, -1)
        mem.auto_write(p, d.next, NULLPTR)

        # Swap ourselves into the tail (RDMA offers CAS, not swap ⇒ CAS loop;
        # Algorithm 2 lines 3-7, "curr updated on rCAS").
        curr: Any = NULLPTR
        while True:
            observed = mem.auto_cas(p, self.tail, expected=curr, swap=p.pid)
            if observed == curr:
                break
            curr = observed

        if curr is NULLPTR:
            # Queue was empty: we are the leader (PlusCal c8).
            mem.auto_write(p, d.budget, self.init_budget)
            return True

        # Link behind the predecessor, then spin on OUR OWN descriptor — a
        # machine-local read; no remote spinning (Algorithm 2 lines 8-10).
        # The wait step goes through the memory's yield_point so the same
        # code runs threaded (GIL yield) or simulated (virtual-time charge).
        pred = self._desc_of(curr)
        mem.auto_write(p, pred.next, p.pid)
        while mem.auto_read(p, d.budget) == -1:
            mem.yield_point()

        if mem.auto_read(p, d.budget) == 0:
            # Budget exhausted: yield the global lock to the other class
            # before entering (Algorithm 2 lines 11-13 — the fairness hook).
            assert self.p_reacquire is not None, "cohort lock not wired to ALock"
            self.p_reacquire(p)
            mem.auto_write(p, d.budget, self.init_budget)
        return False

    def q_unlock(self, p: Process, piggyback=None) -> None:
        """Release: pass to the successor with a decremented budget, or CAS
        the tail back to null (which also releases the Peterson flag).

        ``piggyback`` — optional ``("write", reg, value)`` work requests on
        the lock's home node, executed while the critical section is still
        held: a local releaser applies them directly; a remote releaser
        chains them into the *same doorbell* as the tail-drain rCAS (WR lists
        execute in order, so the writes land before the release linearizes).
        This is how the lock table flushes a grant's register writes without
        paying a separate posting.
        """
        mem = self.mem
        d = self._desc(p)
        if piggyback and p.is_local_to(self.tail):
            for _, reg, value in piggyback:
                mem.write(p, reg, value)
            piggyback = None
        if mem.auto_read(p, d.next) is NULLPTR:
            if piggyback:
                observed = mem.post_batch(
                    p, list(piggyback) + [("cas", self.tail, p.pid, NULLPTR)]
                )[-1]
                piggyback = None
                if observed == p.pid:
                    return  # drained: writes flushed + lock released, 1 doorbell
            elif mem.auto_cas(p, self.tail, expected=p.pid, swap=NULLPTR) == p.pid:
                return  # queue drained; cohort flag now unset ⇒ global released
            # Someone is mid-enqueue: wait for the link (Algorithm 2 line 17).
            while mem.auto_read(p, d.next) is NULLPTR:
                mem.yield_point()
        if piggyback:  # successor path: flush before handing the CS over
            mem.post_batch(p, piggyback)
        nxt = self._desc_of(mem.auto_read(p, d.next))
        handoff = mem.auto_read(p, d.budget) - 1
        mem.auto_write(p, nxt.budget, handoff)  # pass the lock

    def q_is_locked(self, p: Process) -> bool:
        """Peterson "interested" test for this class (Algorithm 2 line 20)."""
        return self.mem.auto_read(p, self.tail) is not NULLPTR

    # ------------------------------------------------- split-phase variant
    # The blocking q_lock/q_unlock pair above is what ALock composes.  The
    # lock table's *inflated keys* need the same queue discipline but
    # cannot block (sim clients are cooperative generator tasks; a spin
    # inside one table call would wedge the engine's atomic step), so the
    # acquire is split into enqueue → poll → pass:
    #
    #   q_enqueue  — publish + swap into the tail + link; NEVER spins.
    #   q_granted  — "has the entitlement reached me?": a machine-local
    #                read of the caller's own budget register (0 RDMA per
    #                poll — the MCS local-spinning property, poll-shaped).
    #   q_pass     — hand the entitlement to the successor (budget - 1,
    #                recycling to init_budget past zero) or drain the tail.
    #
    # There is no p_reacquire hook on this path: the inflated queue has no
    # enclosing Peterson.  Inter-cohort arbitration happens at the shard
    # ALock every grant passes through; a zero budget merely tells the
    # head to defer one poll round to the other cohort (see
    # InflatedKeyQueue.poll), preserving the cohort-budget fairness shape
    # without a second global lock.

    def q_enqueue(self, p: Process) -> bool:
        """Split-phase front half of :meth:`q_lock`: returns ``True`` iff
        the queue was empty (the caller is the cohort leader and already
        entitled — its budget is set to ``init_budget``).  ``False`` means
        parked behind a predecessor: poll :meth:`q_granted`.

        Cost (same as the q_lock front half): a lone remote enqueue is
        1 rCAS; a queued one adds 1 rWrite for the link; every local-class
        call is 0 RDMA.  The tail CAS + link land in one table call, so
        under the sim engine's atomic steps the predecessor can never
        observe the swapped-but-unlinked window.
        """
        mem = self.mem
        d = self._desc(p)
        mem.auto_write(p, d.budget, -1)
        mem.auto_write(p, d.next, NULLPTR)
        curr: Any = NULLPTR
        while True:
            observed = mem.auto_cas(p, self.tail, expected=curr, swap=p.pid)
            if observed == curr:
                break
            curr = observed
        if curr is NULLPTR:
            mem.auto_write(p, d.budget, self.init_budget)
            return True
        pred = self._desc_of(curr)
        mem.auto_write(p, pred.next, p.pid)
        return False

    def q_granted(self, p: Process) -> int:
        """Non-blocking entitlement poll: the caller's own budget register
        (a machine-local read — its descriptor lives on its node).
        ``-1`` = still parked; ``>= 0`` = entitled, value is the budget."""
        return self.mem.auto_read(p, self._desc(p).budget)

    def q_set_budget(self, p: Process, value: int) -> None:
        """Reset the caller's own budget (machine-local write) — used by
        the split-phase defer round when a handed-down budget hits zero."""
        self.mem.auto_write(p, self._desc(p).budget, value)

    def q_has_successor(self, p: Process) -> bool:
        """Is someone linked behind the caller?  One machine-local read of
        the caller's own ``next`` pointer — the direct-handoff peek."""
        return self.mem.auto_read(p, self._desc(p).next) is not NULLPTR

    def q_pass(self, p: Process, payload: Optional[tuple] = None) -> bool:
        """Split-phase release: drain the tail (``True``) or hand the
        entitlement to the successor with a decremented budget (``False``).

        A budget already at zero recycles to ``init_budget - 1`` on the
        way down: with no global lock to reacquire, the zero itself is the
        fairness signal (consumed by the head's defer round), and handing
        a raw ``-1`` would read as "parked" and lose the wakeup.  The
        wait-for-link spin is reachable only threaded — under the sim's
        atomic steps an enqueue's tail CAS and link land in one step.

        ``payload`` rides the same budget write: the successor receives
        ``(budget, *payload)`` instead of the bare integer — the direct
        lock handoff (the releaser already transferred ownership via the
        word; the tuple tells the successor what it now holds).  Costs
        nothing extra: it is the one write the pass was making anyway.
        """
        mem = self.mem
        d = self._desc(p)
        if mem.auto_read(p, d.next) is NULLPTR:
            if mem.auto_cas(p, self.tail, expected=p.pid, swap=NULLPTR) == p.pid:
                return True  # cohort drained
            while mem.auto_read(p, d.next) is NULLPTR:
                mem.yield_point()
        nxt = self._desc_of(mem.auto_read(p, d.next))
        budget = mem.auto_read(p, d.budget)
        if isinstance(budget, tuple):  # an unconsumed direct grant: its
            budget = budget[0]         # budget share still counts down
        handoff = budget - 1 if budget > 0 else self.init_budget - 1
        value = (handoff,) + tuple(payload) if payload is not None else handoff
        mem.auto_write(p, nxt.budget, value)
        return False


LOCAL_COHORT, REMOTE_COHORT = 0, 1


class InflatedKeyQueue:
    """The per-key queue a hot (inflated) lock-table key escalates into.

    Two split-phase :class:`BudgetedMCSLock` cohorts — one for the key's
    home-host clients (every operation machine-local, 0 RDMA), one for
    everyone else (1 rCAS + ≤1 rWrite to enqueue, then local polling) —
    exactly ALock's asymmetric shape, minus the Peterson layer: at most
    one *leader per cohort* is entitled at a time, and the shard ALock
    that every grant transaction already passes through arbitrates
    between the (≤ 2) entitled leaders.  Mixing both classes in ONE queue
    would be unsound: the tail register would see local CAS and rCAS
    interleaved, the non-atomic combination of Table 1.

    The queue is *advisory ordering and admission throttling*: safety
    (mutual exclusion, fencing) always comes from the packed word and the
    shard critical section.  A crashed head strands its cohort only until
    the staleness deadline, after which waiters bypass the queue and probe
    the word directly (the table then deflates the key — disorderly events
    always reset queue state rather than trust it).

    One instance per inflation *epoch*: deflation discards the whole
    object (register names carry the epoch, so re-inflation cannot alias
    a dead epoch's descriptors).
    """

    def __init__(self, mem: AsymmetricMemory, home_node: int,
                 init_budget: int, name: str):
        self.mem = mem
        self.home_node = home_node
        self.cohorts = tuple(
            BudgetedMCSLock(
                mem,
                mem.alloc(home_node, f"{name}.c{cid}.tail", NULLPTR),
                init_budget,
                f"{name}.c{cid}",
            )
            for cid in (LOCAL_COHORT, REMOTE_COHORT)
        )

    def cid_of(self, p: Process) -> int:
        return LOCAL_COHORT if p.node == self.home_node else REMOTE_COHORT

    def enqueue(self, p: Process) -> bool:
        """Join the caller's class cohort; True iff immediately entitled."""
        return self.cohorts[self.cid_of(p)].q_enqueue(p)

    def poll(self, p: Process) -> str:
        """``"parked"`` (not yet head — the poll was one local read, 0
        RDMA), ``"granted"`` (the predecessor handed the lock itself over:
        consume with :meth:`take_grant`), ``"defer"`` (head, but the
        handed budget hit zero and the other cohort is waiting: yield one
        round — the cohort-budget fairness bound), or ``"entitled"``
        (head: go attempt the grant on the word)."""
        cid = self.cid_of(p)
        mine = self.cohorts[cid]
        budget = mine.q_granted(p)
        if isinstance(budget, tuple):
            return "granted"
        if budget < 0:
            return "parked"
        if budget == 0:
            mine.q_set_budget(p, mine.init_budget)
            if self.cohorts[1 - cid].q_is_locked(p):
                return "defer"
        return "entitled"

    def can_direct(self, p: Process) -> bool:
        """May the releaser hand the lock straight to its successor?

        True iff someone is linked behind it AND the cohort-budget
        fairness rule does not owe the other cohort a turn (a handoff
        that would arrive at budget ≤ 0 while the other cohort waits).
        The successor peek and budget read are machine-local; the other
        cohort's tail is read only when the budget actually runs out —
        amortised to one remote read per ``init_budget`` handoffs."""
        cid = self.cid_of(p)
        mine = self.cohorts[cid]
        if not mine.q_has_successor(p):
            return False
        budget = mine.q_granted(p)
        if isinstance(budget, tuple):
            budget = budget[0]
        if budget <= 1:  # successor would land at <= 0: other class's turn?
            return not self.cohorts[1 - cid].q_is_locked(p)
        return True

    def pass_grant(self, p: Process, token: int, expires_at: float) -> bool:
        """Direct handoff: pass the cohort entitlement AND the lock — the
        caller already CAS'd the word over to ``token``; the successor's
        budget register receives ``(budget, token, expires_at)`` and its
        next poll returns ``"granted"``.  Same single write as a plain
        pass.  True iff the cohort drained instead (no successor after
        all — the grant value was never written; the caller must treat
        the handoff as declined)."""
        return self.cohorts[self.cid_of(p)].q_pass(
            p, payload=(token, expires_at))

    def take_grant(self, p: Process) -> Optional[tuple]:
        """Consume a pending direct grant: returns ``(token, expires_at)``
        and resets the budget register to its plain integer share (later
        polls read an ordinary entitlement), or ``None`` if nothing is
        pending."""
        mine = self.cohorts[self.cid_of(p)]
        v = mine.q_granted(p)
        if not isinstance(v, tuple):
            return None
        budget, token, expires_at = v
        mine.q_set_budget(p, budget)
        return (token, expires_at)

    def release(self, p: Process) -> bool:
        """Pass the entitlement within the caller's cohort (or drain it).
        True iff the caller's cohort is now empty."""
        return self.cohorts[self.cid_of(p)].q_pass(p)

    def empty(self, p: Process) -> bool:
        """Both cohorts drained (two tail reads; machine-local for the
        home host).  Used inside grant transactions and by deflation."""
        return not (self.cohorts[LOCAL_COHORT].q_is_locked(p)
                    or self.cohorts[REMOTE_COHORT].q_is_locked(p))
