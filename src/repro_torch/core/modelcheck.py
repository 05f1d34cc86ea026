"""Explicit-state model checker for the paper's PlusCal spec (Appendix A).

TLA+/TLC is not available offline, so this module transcribes the appendix's
``qplock`` PlusCal algorithm into a transition system — one transition per
PlusCal *label* (the spec's atomicity grain) — and exhaustively explores the
reachable state space, checking:

* ``MutualExclusion``      — at most one process at ``cs`` in every state;
* deadlock-freedom         — every reachable state has an enabled transition;
* ``StarvationFree``       — ``(pc[i] = "enter") ~> (pc[i] = "cs")`` under
  weak fairness, checked by searching for a *fair* strongly-connected
  component in which process ``i`` remains inside the entry section forever
  while every continuously-enabled process keeps stepping.  No such SCC ⇒
  starvation-freedom holds (the SCC condition over-approximates the set of
  fair cycles, so an empty result is a proof).

The PlusCal mapping (pids 1..NP; ``Us(pid) = pid % 2 + 1``):

* ``AcquireGlobal`` is inlined twice (call sites ``c5`` and ``p2``) as the
  ``cg*`` / ``pg*`` label families;
* the ``cas`` label of ``ReleaseCohort`` branches to ``r1`` only when the
  tail CAS fails (the appendix's pretty-printer drops the ``else``; the
  C-style Algorithm 2 lines 15-18 fix the intended control flow);
* seeded-bug variants validate the checker itself:
  ``skip_global``   — leaders skip ``AcquireGlobal``  ⇒ mutual exclusion fails;
  ``no_decrement``  — hand-off keeps the budget       ⇒ starvation appears.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

# ----------------------------------------------------------------- labels ---
_LABELS = [
    "p1", "ncs", "enter",
    "c1", "swap", "cwait", "c2", "c3", "c4",
    "cg1", "cgw", "cg2", "cg3", "cg4",
    "c6", "c7", "c8", "c9", "c10",
    "p2",
    "pg1", "pgw", "pg2", "pg3", "pg4",
    "cs",
    "cas", "r1", "r2", "r3",
]
PC = {name: i for i, name in enumerate(_LABELS)}
# Entry section: from the spec's "enter" through the last pre-CS label.
_ENTRY = frozenset(range(PC["enter"], PC["cs"]))
_CS = PC["cs"]
NULL = 0


@dataclass(frozen=True)
class State:
    """One global state of the PlusCal spec (immutable, hashable)."""

    victim: int
    cohort: Tuple[int, int]          # cohort[1], cohort[2]
    pc: Tuple[int, ...]              # per process (index 0 = pid 1)
    budget: Tuple[int, ...]
    next: Tuple[int, ...]
    passed: Tuple[bool, ...]
    pred: Tuple[int, ...]


def _us(pid: int) -> int:
    return (pid % 2) + 1


def _them(pid: int) -> int:
    return ((pid + 1) % 2) + 1


class QPLockSpec:
    """The transition system for ``qplock`` with ``NP`` processes, budget ``B``."""

    def __init__(self, num_procs: int, init_budget: int, variant: str = "paper"):
        assert num_procs > 0 and init_budget > 0, "PlusCal ASSUME"
        assert variant in ("paper", "skip_global", "no_decrement")
        self.np = num_procs
        self.b = init_budget
        self.variant = variant

    # ------------------------------------------------------------- initial --
    def initial_states(self) -> List[State]:
        base = dict(
            cohort=(NULL, NULL),
            pc=tuple(PC["p1"] for _ in range(self.np)),
            budget=tuple(-1 for _ in range(self.np)),
            next=tuple(NULL for _ in range(self.np)),
            passed=tuple(False for _ in range(self.np)),
            pred=tuple(NULL for _ in range(self.np)),
        )
        # ``victim \in {1, 2}`` — both initial choices explored.
        return [State(victim=v, **base) for v in (1, 2)]

    # ---------------------------------------------------------- transitions --
    def step(self, s: State, i: int) -> Optional[State]:
        """Next state if process index ``i`` (pid ``i+1``) takes a step, or
        ``None`` when its transition is disabled (a false ``await``)."""
        pid = i + 1
        pc = s.pc[i]
        us, them = _us(pid), _them(pid)

        def upd(**kw) -> State:
            d = dict(
                victim=s.victim, cohort=s.cohort, pc=s.pc, budget=s.budget,
                next=s.next, passed=s.passed, pred=s.pred,
            )
            d.update(kw)
            return State(**d)

        def setpc(label: str, **kw) -> State:
            pcs = list(s.pc)
            pcs[i] = PC[label]
            return upd(pc=tuple(pcs), **kw)

        def set1(t: Tuple, idx: int, val) -> Tuple:
            l = list(t)
            l[idx] = val
            return tuple(l)

        coh = {1: s.cohort[0], 2: s.cohort[1]}

        name = _LABELS[pc]
        if name == "p1":
            return setpc("ncs")
        if name == "ncs":
            return setpc("enter")
        if name == "enter":
            return setpc("c1")
        if name == "c1":
            return setpc(
                "swap", budget=set1(s.budget, i, -1), next=set1(s.next, i, NULL)
            )
        if name == "swap":
            # pred := cohort[Us]; cohort[Us] := self   (atomic swap label)
            new_coh = set1(s.cohort, us - 1, pid)
            return setpc("cwait", pred=set1(s.pred, i, coh[us]), cohort=new_coh)
        if name == "cwait":
            return setpc("c2") if s.pred[i] != NULL else setpc("c8")
        if name == "c2":
            pred_idx = s.pred[i] - 1
            return setpc("c3", next=set1(s.next, pred_idx, pid))
        if name == "c3":
            if s.budget[i] < 0:
                return None  # await Budget(self) >= 0
            return setpc("c4")
        if name == "c4":
            return setpc("cg1") if s.budget[i] == 0 else setpc("c7")
        if name in ("cg1", "pg1"):
            if self.variant == "skip_global":
                return setpc("c6" if name == "cg1" else "cs")
            return setpc("cgw" if name == "cg1" else "pgw", victim=pid)
        if name in ("cgw", "pgw"):
            return setpc("cg2" if name == "cgw" else "pg2")
        if name in ("cg2", "pg2"):
            done = "cg4" if name == "cg2" else "pg4"
            nxt = "cg3" if name == "cg2" else "pg3"
            return setpc(done) if coh[them] == NULL else setpc(nxt)
        if name in ("cg3", "pg3"):
            done = "cg4" if name == "cg3" else "pg4"
            back = "cgw" if name == "cg3" else "pgw"
            return setpc(done) if s.victim != pid else setpc(back)
        if name == "cg4":
            return setpc("c6")
        if name == "c6":
            return setpc("c7", budget=set1(s.budget, i, self.b))
        if name == "c7":
            return setpc("c10", passed=set1(s.passed, i, True))
        if name == "c8":
            return setpc("c9", budget=set1(s.budget, i, self.b))
        if name == "c9":
            return setpc("c10", passed=set1(s.passed, i, False))
        if name == "c10":
            return setpc("p2")
        if name == "p2":
            if self.variant == "skip_global":
                return setpc("cs")
            return setpc("cs") if s.passed[i] else setpc("pg1")
        if name == "pg4":
            return setpc("cs")
        if name == "cs":
            return setpc("cas")
        if name == "cas":
            if coh[us] == pid:
                return setpc("r3", cohort=set1(s.cohort, us - 1, NULL))
            return setpc("r1")
        if name == "r1":
            if s.next[i] == NULL:
                return None  # await descriptor[self].next /= 0
            return setpc("r2")
        if name == "r2":
            succ_idx = s.next[i] - 1
            handoff = s.budget[i] if self.variant == "no_decrement" else s.budget[i] - 1
            return setpc("r3", budget=set1(s.budget, succ_idx, handoff))
        if name == "r3":
            return setpc("p1")
        raise AssertionError(f"unhandled label {name}")


# ------------------------------------------------------------------ checker --
@dataclass
class CheckResult:
    num_states: int
    mutual_exclusion: bool
    deadlock_free: bool
    starvation_free: bool
    violations: Dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.mutual_exclusion and self.deadlock_free and self.starvation_free


def check(
    num_procs: int = 2,
    init_budget: int = 1,
    variant: str = "paper",
    max_states: int = 2_000_000,
) -> CheckResult:
    """Exhaustively explore the spec and check all three properties."""
    spec = QPLockSpec(num_procs, init_budget, variant)
    index: Dict[State, int] = {}
    states: List[State] = []
    # edges[s] = list of (succ_index, proc_index); enabled[s] = bitmask.
    edges: List[List[Tuple[int, int]]] = []
    enabled: List[int] = []

    frontier = []
    for s0 in spec.initial_states():
        if s0 not in index:
            index[s0] = len(states)
            states.append(s0)
            frontier.append(index[s0])
            edges.append([])
            enabled.append(0)

    mutex_ok, deadlock_ok = True, True
    violations: Dict[str, str] = {}

    head = 0
    while head < len(frontier):
        si = frontier[head]
        head += 1
        s = states[si]

        in_cs = sum(1 for pc in s.pc if pc == _CS)
        if in_cs > 1 and mutex_ok:
            mutex_ok = False
            violations["mutual_exclusion"] = f"state with {in_cs} processes in cs: {s}"

        mask = 0
        succs: List[Tuple[int, int]] = []
        for i in range(spec.np):
            t = spec.step(s, i)
            if t is None:
                continue
            mask |= 1 << i
            ti = index.get(t)
            if ti is None:
                ti = len(states)
                index[t] = ti
                states.append(t)
                edges.append([])
                enabled.append(0)
                frontier.append(ti)
                if len(states) > max_states:
                    raise RuntimeError(f"state space exceeds {max_states}")
            succs.append((ti, i))
        edges[si] = succs
        enabled[si] = mask
        if mask == 0 and deadlock_ok:
            deadlock_ok = False
            violations["deadlock"] = f"no enabled transition in {s}"

    starvation_ok = True
    if mutex_ok and deadlock_ok:
        for i in range(spec.np):
            scc = _fair_entry_scc(spec, states, edges, enabled, i)
            if scc is not None:
                starvation_ok = False
                violations["starvation"] = (
                    f"process {i + 1} can remain in the entry section forever: "
                    f"fair SCC of {len(scc)} states, e.g. {states[next(iter(scc))]}"
                )
                break

    return CheckResult(
        num_states=len(states),
        mutual_exclusion=mutex_ok,
        deadlock_free=deadlock_ok,
        starvation_free=starvation_ok,
        violations=violations,
    )


def _fair_entry_scc(
    spec: QPLockSpec,
    states: Sequence[State],
    edges: Sequence[Sequence[Tuple[int, int]]],
    enabled: Sequence[int],
    i: int,
) -> Optional[FrozenSet[int]]:
    """Find a fair SCC where process ``i`` never leaves the entry section.

    Subgraph: states with ``pc[i]`` in the entry section, edges staying inside.
    An SCC ``C`` (nontrivial) is a *fair* starvation witness iff every process
    that is enabled in **all** states of ``C`` takes at least one step inside
    ``C`` (weak fairness cannot rule the loop out).
    """
    n = len(states)
    in_sub = [states[s].pc[i] in _ENTRY for s in range(n)]

    # Iterative Tarjan on the subgraph.
    index_of = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: List[int] = []
    counter = 0
    sccs: List[List[int]] = []

    for root in range(n):
        if not in_sub[root] or index_of[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, ei = work[-1]
            if ei == 0:
                index_of[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            subedges = [t for (t, _p) in edges[v] if in_sub[t]]
            while ei < len(subedges):
                w = subedges[ei]
                ei += 1
                if index_of[w] == -1:
                    work[-1] = (v, ei)
                    work.append((w, 0))
                    advanced = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index_of[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index_of[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(comp)
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])

    for comp in sccs:
        comp_set = set(comp)
        # Which processes step inside C?  Which are enabled in all of C?
        steps = 0
        enabled_all = (1 << spec.np) - 1
        for s in comp:
            enabled_all &= enabled[s]
            for (t, p) in edges[s]:
                if t in comp_set:
                    steps |= 1 << p
        if enabled_all & ~steps == 0:  # every always-enabled process steps ⇒ fair
            return frozenset(comp_set)
    return None
