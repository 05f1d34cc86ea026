"""ALock — the paper's asymmetric mutual-exclusion primitive, plus baselines.

``ALock`` composes the modified Peterson's lock (Algorithm 1) with one
budgeted MCS queue lock per class (Algorithm 2).  Processes on the lock's home
node form the *local* class (cid 0) and never issue an RDMA operation;
everyone else forms the *remote* class (cid 1) and pays a bounded number of
RDMA operations per acquisition (1 rCAS, +1 rWrite when queued; release
≤ 1 rCAS + 1 rWrite) with no remote spinning after enqueue.

Baselines implemented for the paper's comparisons (§1, §3, §4):

* :class:`NaiveRCASLock` — everyone (including local processes, via RDMA
  *loopback*) spins with ``rCAS`` on one word.  Correct (the RNIC serialises
  remote RMWs) but local processes pay loopback and remote processes spin over
  the network; not starvation-free.
* :class:`RPCLock` — a server thread on the home node grants the lock FIFO
  over message queues; every operation costs a round-trip message, nullifying
  one-sided RDMA's benefit.
* :class:`FilterLock` — Peterson's n-process filter generalisation using only
  read/write registers (safe under asymmetry) but with remote spinning and
  O(n) remote accesses per acquisition even without contention — the
  pathology that motivates the paper's design (§3).
* :class:`BrokenMixedCASLock` — local ``CAS`` vs remote ``rCAS`` on the same
  word.  **Deliberately incorrect** under Table-1 atomicity; exists so the
  tests can demonstrate that the simulated memory reproduces the hazard the
  paper's design avoids.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, List, Optional

from .memory import NULLPTR, AsymmetricMemory, Process, Register
from .mcs import BudgetedMCSLock
from .peterson import ModifiedPetersonLock

_uid = itertools.count()

LOCAL, REMOTE = 0, 1


class ALock:
    """The paper's primitive: modified Peterson + per-class budgeted MCS."""

    def __init__(
        self,
        mem: AsymmetricMemory,
        home_node: int,
        init_budget: int = 4,
        name: Optional[str] = None,
    ):
        self.mem = mem
        self.home_node = home_node
        self.name = name or f"alock{next(_uid)}"
        # cohort[2]: the MCS tails double as the Peterson interested flags.
        tails = [
            mem.alloc(home_node, f"{self.name}.cohort{cid}", NULLPTR)
            for cid in (LOCAL, REMOTE)
        ]
        victim = mem.alloc(home_node, f"{self.name}.victim", LOCAL)
        self.cohorts = [
            BudgetedMCSLock(mem, tails[cid], init_budget, f"{self.name}.c{cid}")
            for cid in (LOCAL, REMOTE)
        ]
        self.global_lock = ModifiedPetersonLock(mem, victim, self.cohorts)
        for cid in (LOCAL, REMOTE):
            # Embed the global lock's reacquire into the cohort lock (the
            # budget-exhaustion fairness hook, Algorithm 2 line 12).
            self.cohorts[cid].p_reacquire = self._make_reacquire(cid)

    def _make_reacquire(self, cid: int):
        def hook(p: Process) -> None:
            self.global_lock.reacquire(p, cid)

        return hook

    def class_of(self, p: Process) -> int:
        """``getCid()``: locality of the process w.r.t. the lock's registers."""
        return LOCAL if p.node == self.home_node else REMOTE

    def lock(self, p: Process, piggyback_reads=None):
        """``pLock`` (Algorithm 1 lines 1-7).

        ``piggyback_reads`` — optional registers on the home node to read in
        the same doorbell as the (remote-class) Peterson engagement.  Returns
        their values when the fast entry validated them (see
        :meth:`ModifiedPetersonLock.acquire`), else ``None`` — in which case
        the caller must (re-)read inside the critical section.  Local-class
        callers and intra-cohort hand-offs always return ``None``.
        """
        cid = self.class_of(p)
        is_leader = self.cohorts[cid].q_lock(p)
        if is_leader:
            return self.global_lock.acquire(p, cid, piggyback_reads)
        # else: the global lock was passed to us inside the cohort.
        return None

    def unlock(self, p: Process, piggyback=None) -> None:
        """``pUnlock`` (Algorithm 1 lines 9-11).

        ``piggyback`` — optional ``("write", reg, value)`` WRs flushed while
        the critical section is still held; remote releasers chain them into
        the tail-drain doorbell (see :meth:`BudgetedMCSLock.q_unlock`).
        """
        self.cohorts[self.class_of(p)].q_unlock(p, piggyback)

    # Context-manager sugar used by the coordination service.
    class _Guard:
        def __init__(self, lk: "ALock", p: Process):
            self.lk, self.p = lk, p

        def __enter__(self):
            self.lk.lock(self.p)
            return self

        def __exit__(self, *exc):
            self.lk.unlock(self.p)
            return False

    def guard(self, p: Process) -> "ALock._Guard":
        return ALock._Guard(self, p)


# --------------------------------------------------------------------------
# Baselines
# --------------------------------------------------------------------------
class NaiveRCASLock:
    """All processes use ``rCAS`` (locals via loopback).  Paper §3 ¶1."""

    def __init__(self, mem: AsymmetricMemory, home_node: int, name: Optional[str] = None):
        self.mem = mem
        self.name = name or f"naive{next(_uid)}"
        self.word = mem.alloc(home_node, f"{self.name}.word", 0)

    def lock(self, p: Process) -> None:
        # Loopback: even local processes go through the RNIC so that RMWs are
        # mutually atomic — the exact overhead the paper eliminates.
        while self.mem.rcas(p, self.word, 0, 1) != 0:
            self.mem.yield_point()  # remote spinning

    def unlock(self, p: Process) -> None:
        self.mem.rwrite(p, self.word, 0)


class RPCLock:
    """A server thread on the home node serialises lock grants (FIFO).

    Message counts stand in for the RPC round-trips the paper says nullify
    one-sided RDMA's benefit.  ``shutdown()`` must be called to join the
    server thread.
    """

    def __init__(self, mem: AsymmetricMemory, home_node: int):
        self.home_node = home_node
        self.requests: "queue.Queue[tuple]" = queue.Queue()
        self.grants: Dict[int, "queue.Queue"] = {}
        self.messages_sent: Dict[int, int] = {}
        self._guard = threading.Lock()
        self._stop = object()
        self._server = threading.Thread(target=self._serve, daemon=True)
        self._server.start()

    def _mailbox(self, p: Process) -> "queue.Queue":
        with self._guard:
            if p.pid not in self.grants:
                self.grants[p.pid] = queue.Queue()
                self.messages_sent[p.pid] = 0
            return self.grants[p.pid]

    def _serve(self) -> None:
        holder: Optional[int] = None
        waiting: List[int] = []
        while True:
            msg = self.requests.get()
            if msg is self._stop:
                return
            kind, pid = msg
            if kind == "lock":
                if holder is None:
                    holder = pid
                    self.grants[pid].put("granted")
                else:
                    waiting.append(pid)
            elif kind == "unlock":
                assert holder == pid, "RPC unlock by non-holder"
                if waiting:
                    holder = waiting.pop(0)
                    self.grants[holder].put("granted")
                else:
                    holder = None

    def lock(self, p: Process) -> None:
        box = self._mailbox(p)
        self.messages_sent[p.pid] += 1  # request
        self.requests.put(("lock", p.pid))
        box.get()  # reply (blocks until granted)
        self.messages_sent[p.pid] += 1  # count the reply round-trip

    def unlock(self, p: Process) -> None:
        self.messages_sent[p.pid] += 1
        self.requests.put(("unlock", p.pid))

    def shutdown(self) -> None:
        self.requests.put(self._stop)
        self._server.join(timeout=5)


class FilterLock:
    """Peterson's filter lock for n processes over read/write registers only.

    Correct under operation asymmetry (no RMW at all) but requires remote
    spinning and O(n) remote accesses per acquisition — the paper's argument
    for why the classic generalisations don't fit RDMA (§3).
    """

    def __init__(self, mem: AsymmetricMemory, home_node: int, pids: List[int]):
        self.mem = mem
        self.n = len(pids)
        self.slot = {pid: i for i, pid in enumerate(pids)}
        uid = next(_uid)
        self.level = [
            mem.alloc(home_node, f"filter{uid}.level{i}", -1) for i in range(self.n)
        ]
        self.victim = [
            mem.alloc(home_node, f"filter{uid}.victim{j}", -1) for j in range(self.n)
        ]

    def lock(self, p: Process) -> None:
        me = self.slot[p.pid]
        for lvl in range(1, self.n):
            self.mem.auto_write(p, self.level[me], lvl)
            self.mem.auto_write(p, self.victim[lvl], me)
            while self._exists_conflict(p, me, lvl):
                self.mem.yield_point()

    def _exists_conflict(self, p: Process, me: int, lvl: int) -> bool:
        if self.mem.auto_read(p, self.victim[lvl]) != me:
            return False
        for k in range(self.n):
            if k != me and self.mem.auto_read(p, self.level[k]) >= lvl:
                return True
        return False

    def unlock(self, p: Process) -> None:
        self.mem.auto_write(p, self.level[self.slot[p.pid]], -1)


class BrokenMixedCASLock:
    """DELIBERATELY BROKEN: local ``CAS`` mixed with remote ``rCAS``.

    Table 1: local and remote RMW are not mutually atomic, so this lock can
    admit two holders.  Used by tests to prove the memory model reproduces
    the hazard; never use outside tests.
    """

    def __init__(self, mem: AsymmetricMemory, home_node: int):
        self.mem = mem
        self.word = mem.alloc(home_node, f"broken{next(_uid)}.word", 0)

    def lock(self, p: Process) -> None:
        if p.is_local_to(self.word):
            while self.mem.cas(p, self.word, 0, 1) != 0:
                self.mem.yield_point()
        else:
            while self.mem.rcas(p, self.word, 0, 1) != 0:
                self.mem.yield_point()

    def unlock(self, p: Process) -> None:
        self.mem.auto_write(p, self.word, 0)
