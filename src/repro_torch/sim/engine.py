"""Deterministic discrete-event engine: virtual time for the lock stack.

The threaded benchmarks run clients as OS threads over wall-clock
``time.sleep`` — which caps a run at a handful of hosts and makes identical
configs scatter ±30 % across seeds.  This engine replaces both: a **virtual
clock** that only moves when the simulation says so, and a **seeded
scheduler** that runs cooperative client *tasks* (plain Python generators)
one at a time in a fully reproducible order.  Two runs with the same seed
execute the same events in the same order and produce byte-identical
telemetry; 64 hosts × 16 clients is just 1024 generators on one thread.

Execution model
---------------

* A task is a generator.  Each ``next()`` runs one **step**; the value it
  yields is how long (in virtual seconds) to park before the next step
  (``None``/``0`` ⇒ reschedule at the current instant, behind any event
  already due).  A step runs **atomically**: no other task interleaves with
  it, so everything a step does (a whole lock-table transaction, say) is a
  single indivisible action in the simulated history.  Interleaving
  granularity is therefore *one step* — coarser than the threaded stress
  tests' per-register preemption, and exactly the granularity the per-class
  operation counts are stated at.
* Code running inside a step charges virtual time through
  :meth:`VirtualClock.advance` (the sim fabric does this per doorbell /
  work request — see ``repro_torch.sim.fabric``) and reads it through the clock's
  call operator, which is what ``ShardedLockTable(clock=...)`` expects.
* A step starts at its scheduled instant and its charges extend **only its
  own task's timeline**: the task's next event lands at step start + charges
  + the yielded delay.  Different tasks' charged durations therefore overlap
  in virtual time, the way parallel clients overlap on real hardware — a
  1024-client fleet is not serialised onto one virtual pipe.  The cost of
  that parallelism is bounded clock skew: a step's register effects apply
  atomically at its *start*, and the global clock rebases to each step's
  start (monotonic per task, and dispatch is globally time-sorted, but not
  monotonic across consecutive steps of different tasks).
* Events due at the same instant are ordered by a **seeded** tie-break: a
  per-scheduling draw from ``random.Random(seed)``.  Same seed ⇒ same
  order; different seeds explore different interleavings (the virtual-time
  analogue of ``make_scheduler``'s yield fuzzing).

Blocking code and the livelock guard
------------------------------------

Because steps are atomic, a *cross-task* busy-wait inside a step (e.g. an
ALock spin waiting for another client) can never be satisfied — the other
task cannot run until the step ends.  The lock stack's spin loops all route
through ``AsymmetricMemory.yield_point``; in sim mode that hook is
:meth:`SimEngine.yield_point`, which charges a small spin cost and raises
:class:`SimLivelockError` after ``spin_limit`` iterations inside one step.
In a correctly-structured sim workload (non-blocking table calls, or
blocking calls bounded by a timeout on the same virtual clock) the guard
never fires; if it does, it names a real modeling bug instead of hanging.

``SimEngine.sleep_inline`` is the matching hook for the table's injected
``sleep``: it advances the clock in place, so a *timeout-bounded* blocking
call (``acquire(..., timeout=...)``/``acquire_batch``) terminates in zero
wall time — the poll loop charges virtual time until the deadline trips.
Its guard is a per-step budget of *virtual seconds slept* (``sleep_horizon``,
default one virtual hour), so any sane timeout passes regardless of poll
granularity while an untimed blocking call still fails deterministically.
"""

from __future__ import annotations

import heapq
import itertools
import random
from typing import Callable, Dict, Generator, List, Optional, Tuple

__all__ = ["SimEngine", "SimLivelockError", "VirtualClock"]


class SimLivelockError(RuntimeError):
    """A spin loop inside one atomic task step exceeded the spin limit.

    With atomic steps, a condition another task must establish cannot change
    mid-step — the spin would run forever.  Raising (deterministically, at a
    fixed iteration count) converts the hang into a diagnosable failure.
    """


class VirtualClock:
    """A monotonic virtual clock: ``clock()`` reads, ``advance(dt)`` moves.

    Drop-in for the ``clock`` hooks throughout the stack
    (``ShardedLockTable``, ``CoordinationService``, ``AsymmetricMemory``):
    a zero-argument callable returning seconds as a float.
    """

    __slots__ = ("now",)

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance the virtual clock by {dt}")
        self.now += dt
        return self.now


class SimEngine:
    """Seeded discrete-event scheduler over cooperative generator tasks."""

    def __init__(self, seed: int = 0, spin_cost: float = 0.5e-6,
                 spin_limit: int = 100_000, sleep_horizon: float = 3600.0):
        self.seed = seed
        self.clock = VirtualClock()
        self.spin_cost = spin_cost
        self.spin_limit = spin_limit
        self.sleep_horizon = sleep_horizon
        self._rng = random.Random(seed)
        self._seq = itertools.count()  # FIFO among equal (time, tiebreak)
        self._heap: List[Tuple[float, float, int, Generator]] = []
        self._live = 0
        self.events = 0   # task steps dispatched
        self.spins = 0    # total yield_point invocations
        self.kills = 0    # exceptions delivered via kill()
        self._step_spins = 0
        self._step_slept = 0.0
        # Pending crash deliveries: task -> exception, thrown into the task
        # at its next dispatch (see kill()).
        self._interrupts: Dict[Generator, BaseException] = {}

    # ------------------------------------------------------------- scheduling
    def spawn(self, task: Generator, delay: float = 0.0) -> Generator:
        """Register a generator task; its first step runs at ``now+delay``."""
        if not hasattr(task, "send"):
            raise TypeError(f"task must be a generator, got {type(task)!r}")
        self._live += 1
        self._push(task, self.clock.now + float(delay))
        return task

    def _push(self, task: Generator, at: float) -> None:
        # The seeded tie-break: equal-time events run in an order drawn from
        # the engine RNG (deterministic per seed, diverse across seeds).  The
        # monotone sequence number keeps the tuple comparison from ever
        # reaching the (unorderable) generator object.
        heapq.heappush(
            self._heap, (at, self._rng.random(), next(self._seq), task)
        )

    def kill(self, task: Generator, exc: BaseException) -> None:
        """Deliver ``exc`` into ``task`` at its **next dispatch** (thrown at
        the yield where the task is parked), modeling a process crash.

        Delivery-at-dispatch keeps the crash deterministic and honest: a
        step is atomic, so a process cannot die *mid-step* from the
        outside — it dies the next time it would have acted, which is what
        a silently-dead host looks like to the rest of the cluster.  (For
        crashes *inside* a protocol window, use the synchronous
        ``FaultInjector`` crash points instead — the two compose.)  The
        task must catch the exception to survive as a restarted client;
        an uncaught delivery propagates out of :meth:`run`, turning an
        unhandled crash into a visible test failure.  Killing the same
        task again before it runs replaces the pending exception."""
        self._interrupts[task] = exc

    @property
    def live_tasks(self) -> int:
        return self._live

    @property
    def pending_events(self) -> int:
        return len(self._heap)

    # ------------------------------------------------- in-step blocking hooks
    def yield_point(self) -> None:
        """Spin-loop hook (``AsymmetricMemory.yield_point`` in sim mode)."""
        self.spins += 1
        self._step_spins += 1
        if self._step_spins > self.spin_limit:
            raise SimLivelockError(
                f"{self._step_spins} spin iterations inside one atomic task "
                "step: a cross-task wait can never be satisfied mid-step "
                "(use non-blocking table calls, or bound the wait with a "
                "timeout on the sim clock)"
            )
        self.clock.advance(self.spin_cost)

    def sleep_inline(self, dt: float) -> None:
        """Charging sleep (``ShardedLockTable(sleep=...)`` in sim mode).

        Advances virtual time in place: a timeout-bounded poll loop burns
        virtual seconds until its deadline fires, costing zero wall time.
        The budget here is *virtual time slept per step* (``sleep_horizon``),
        not iterations — a legitimate 60 s timeout at a 0.5 ms poll needs
        120 000 polls and must not trip the spin guard, while an *untimed*
        blocking call would sleep the clock toward infinity and instead
        fails deterministically at the horizon.
        """
        self.clock.advance(dt)
        self._step_slept += dt
        if self._step_slept > self.sleep_horizon:
            raise SimLivelockError(
                f"slept {self._step_slept:.1f} virtual seconds inside one "
                "atomic task step (sleep_horizon="
                f"{self.sleep_horizon}): an unbounded blocking call cannot "
                "make progress in sim mode (pass a timeout, or restructure "
                "as try/yield)"
            )

    # -------------------------------------------------------------------- run
    def run(self, until: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None,
            max_events: Optional[int] = None) -> float:
        """Dispatch events until the heap drains, ``until`` passes, ``stop()``
        turns true (checked between steps), or ``max_events`` steps ran.

        Returns the virtual time.  ``max_events`` exhaustion raises — a sim
        that needs more steps than its author budgeted is livelocked or
        mis-scaled, and silently stopping would corrupt the measurements.
        """
        heap = self._heap
        dispatched = 0
        while heap:
            if stop is not None and stop():
                break
            at = heap[0][0]
            if until is not None and at > until:
                self.clock.now = max(self.clock.now, until)
                break
            if max_events is not None and dispatched >= max_events:
                raise SimLivelockError(
                    f"simulation exceeded max_events={max_events} "
                    f"(virtual t={self.clock.now:.6f}s, "
                    f"{self._live} live tasks)"
                )
            _, _, _, task = heapq.heappop(heap)
            # The step runs on ITS task's timeline: rebase the clock to the
            # step's scheduled instant (which may be earlier than the charged
            # end-time of the previous step — tasks' work overlaps in virtual
            # time, the way parallel clients overlap on real hardware).
            # Dispatch order is still globally time-sorted, and each task's
            # own timeline is monotonic.
            self.clock.now = at
            self.events += 1
            dispatched += 1
            self._step_spins = 0
            self._step_slept = 0.0
            exc = self._interrupts.pop(task, None)
            try:
                if exc is not None:
                    self.kills += 1
                    delay = task.throw(exc)
                else:
                    delay = next(task)
            except StopIteration:
                self._live -= 1
                continue
            dt = 0.0 if delay is None else float(delay)
            if dt < 0:
                raise ValueError(f"task yielded a negative delay {dt}")
            # Reschedule relative to *post-step* time: the step may have
            # charged the clock (fabric latency), and virtual time, like real
            # time, never runs backwards.
            self._push(task, self.clock.now + dt)
        return self.clock.now
