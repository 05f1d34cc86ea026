"""Overload protection: retry budgets, circuit breakers, hedge thresholds.

The paper's asymmetry bounds *per-op* RDMA cost, but nothing bounds
*aggregate* behavior when offered load exceeds a home host's capacity:
individually backoff-limited retries are globally unbudgeted, and one
congested host head-of-line-blocks every client that routes a key there —
the metastable retry-storm collapse Chung & Zamanian observed in RDMA lock
managers (arXiv 1507.03274).  ALock (arXiv 2404.17980) argues the remedy is
a *load-aware client protocol*; this module is that protocol's local state:

* :class:`RetryBudget` — a token bucket per destination host.  Retries (and
  hedges) consume tokens, successes refill them, so a client's aggregate
  retry traffic against one host is bounded no matter how many individual
  ops are each "within their own backoff schedule".
* :class:`CircuitBreaker` — per destination host, trips when the recent
  failure rate crosses a threshold and converts further attempts into
  **fast local refusals** (zero RDMA ops).  After a seeded cooldown one
  half-open trial probes recovery: success closes the breaker, failure
  re-opens it with exponentially longer cooldown.  An open breaker is
  evidence the host is *slow or unreachable from here* — grounds for
  SUSPECT in the membership protocol, never for DEAD (only missed
  heartbeats may kill; see ``repro_torch.coord.membership``).
* :class:`LatencyTracker` — a bounded ring of observed probe latencies per
  destination; its p99 is the hedging threshold (a read-only probe that
  outlives the p99 may be re-posted once, first response wins).

Everything is deterministic: no wall clock (callers pass ``now`` from the
table's injected clock), and the only randomness — half-open cooldown
jitter — comes from a seeded RNG, so two same-seed sim runs trip, refuse,
probe and recover identically.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List

from ..core import Overloaded

__all__ = ["OverloadPolicy", "RetryBudget", "CircuitBreaker",
           "LatencyTracker", "OverloadControl"]

_INF = float("inf")


@dataclass(frozen=True)
class OverloadPolicy:
    """Tunables for the overload-protection layer (all deterministic)."""

    # Retry budget: a token bucket per destination host.
    budget_capacity: float = 32.0   # max (and initial) tokens
    budget_retry_cost: float = 1.0  # tokens one client-level retry consumes
    budget_refill: float = 0.5      # tokens one success restores
    # Circuit breaker: sliding outcome window per destination host.
    breaker_window: int = 32        # outcomes remembered
    breaker_min_samples: int = 8    # no verdict before this many
    breaker_threshold: float = 0.5  # failure rate that trips the breaker
    breaker_cooldown: float = 2e-3  # OPEN hold before the half-open trial
    breaker_backoff: float = 2.0    # cooldown multiplier per re-trip
    breaker_max_cooldown: float = 32e-3
    # Hedged probes: p99-tracked latency threshold per destination host.
    hedge_quantile: float = 0.99
    hedge_window: int = 64          # latency samples retained
    hedge_min_samples: int = 16     # no hedging before the tracker warms
    hedge_cost: float = 1.0         # budget tokens one hedge consumes


class RetryBudget:
    """Token-bucket retry budget for one destination host.

    Intentionally *not* time-based: tokens are created by successes and
    destroyed by retries, so the steady-state retry rate can never exceed
    ``budget_refill / budget_retry_cost`` retries per success — the
    amplification bound that keeps a congested host's queue from feeding
    itself.
    """

    __slots__ = ("tokens", "capacity", "retry_cost", "refill_amount")

    def __init__(self, policy: OverloadPolicy):
        self.tokens = policy.budget_capacity
        self.capacity = policy.budget_capacity
        self.retry_cost = policy.budget_retry_cost
        self.refill_amount = policy.budget_refill

    def spend(self, cost: float) -> bool:
        """Consume ``cost`` tokens; ``False`` (and no change) if short."""
        if self.tokens < cost:
            return False
        self.tokens -= cost
        return True

    def refill(self) -> None:
        self.tokens = min(self.capacity, self.tokens + self.refill_amount)


class CircuitBreaker:
    """Per-destination breaker: CLOSED → OPEN → HALF_OPEN → CLOSED.

    Outcomes (success/failure of remote attempts against the host) feed a
    sliding window; when at least ``breaker_min_samples`` outcomes exist and
    the failure fraction reaches ``breaker_threshold``, the breaker OPENs:
    :meth:`allow` refuses locally until a seeded cooldown elapses, then
    admits exactly one half-open trial.  The trial's outcome decides:
    success closes the breaker (window reset), failure re-opens it with the
    cooldown doubled (capped).
    """

    __slots__ = ("state", "window", "outcomes", "min_samples", "threshold",
                 "cooldown", "base_cooldown", "backoff", "max_cooldown",
                 "retry_at", "trial_pending", "trips", "_rng")

    def __init__(self, policy: OverloadPolicy, rng: random.Random):
        self.state = "closed"
        self.window = policy.breaker_window
        self.outcomes: List[bool] = []
        self.min_samples = policy.breaker_min_samples
        self.threshold = policy.breaker_threshold
        self.base_cooldown = policy.breaker_cooldown
        self.cooldown = policy.breaker_cooldown
        self.backoff = policy.breaker_backoff
        self.max_cooldown = policy.breaker_max_cooldown
        self.retry_at = 0.0
        self.trial_pending = False
        self.trips = 0
        self._rng = rng

    def _open(self, now: float) -> None:
        self.state = "open"
        self.trips += 1
        self.trial_pending = False
        # Seeded jitter on the half-open instant: a fleet of clients whose
        # breakers tripped together must not re-probe in lockstep.
        self.retry_at = now + self.cooldown * (0.75 + 0.5 * self._rng.random())
        self.cooldown = min(self.cooldown * self.backoff, self.max_cooldown)

    def allow(self, now: float) -> bool:
        """May an attempt against this host proceed at ``now``?"""
        if self.state == "closed":
            return True
        if self.state == "open" and now >= self.retry_at:
            self.state = "half_open"
        if self.state == "half_open" and not self.trial_pending:
            self.trial_pending = True   # exactly one probe tests recovery
            return True
        return False

    def record(self, ok: bool, now: float) -> None:
        """Feed one attempt outcome (the half-open trial resolves here)."""
        if self.state == "half_open":
            self.trial_pending = False
            if ok:
                self.state = "closed"
                self.outcomes.clear()
                self.cooldown = self.base_cooldown
            else:
                self._open(now)
            return
        if self.state == "open":
            return  # refused callers never reached the fabric
        self.outcomes.append(ok)
        if len(self.outcomes) > self.window:
            del self.outcomes[0]
        if len(self.outcomes) >= self.min_samples:
            failures = self.outcomes.count(False)
            if failures / len(self.outcomes) >= self.threshold:
                self._open(now)


class LatencyTracker:
    """Bounded ring of observed latencies; quantile = hedging threshold."""

    __slots__ = ("samples", "window", "quantile", "min_samples", "_pos")

    def __init__(self, policy: OverloadPolicy):
        self.samples: List[float] = []
        self.window = policy.hedge_window
        self.quantile = policy.hedge_quantile
        self.min_samples = policy.hedge_min_samples
        self._pos = 0

    def record(self, dt: float) -> None:
        if len(self.samples) < self.window:
            self.samples.append(dt)
        else:  # ring overwrite, deterministic position
            self.samples[self._pos] = dt
            self._pos = (self._pos + 1) % self.window

    def threshold(self) -> float:
        """The tracked quantile, or +inf while the tracker is cold."""
        if len(self.samples) < self.min_samples:
            return _INF
        ys = sorted(self.samples)
        return ys[min(len(ys) - 1, int(self.quantile * len(ys)))]


class OverloadControl:
    """Per-destination budgets + breakers + latency trackers, one bundle.

    Owned by the lock table (one per table, covering every remote host a
    client can route to) and consulted on the remote paths: breaker check
    before posting, outcome recording after, budget spend per client-level
    retry, hedge admission for read-only probes.  All counters here are the
    *local-refusal* side of the telemetry; the per-shard ``sheds`` /
    ``deadline_exceeded`` counters live on :class:`~repro_torch.coord.LockShard`.
    """

    def __init__(self, policy: OverloadPolicy = None, seed: int = 0):
        self.policy = policy or OverloadPolicy()
        self._rng = random.Random(0x0B0D6E7 * (seed + 1))
        self._budgets: Dict[int, RetryBudget] = {}
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._latency: Dict[int, LatencyTracker] = {}
        self.breaker_refusals = 0
        self.budget_refusals = 0
        self.hedges = 0

    # ------------------------------------------------------------ accessors
    def budget(self, host: int) -> RetryBudget:
        b = self._budgets.get(host)
        if b is None:
            b = self._budgets[host] = RetryBudget(self.policy)
        return b

    def breaker(self, host: int) -> CircuitBreaker:
        b = self._breakers.get(host)
        if b is None:
            b = self._breakers[host] = CircuitBreaker(self.policy, self._rng)
        return b

    def latency(self, host: int) -> LatencyTracker:
        t = self._latency.get(host)
        if t is None:
            t = self._latency[host] = LatencyTracker(self.policy)
        return t

    # ------------------------------------------------------------- protocol
    def admit_remote(self, host: int, now: float) -> None:
        """Gate one remote attempt; raises :class:`Overloaded` when refused
        (a fast local refusal: zero RDMA ops were — and will be — spent)."""
        if not self.breaker(host).allow(now):
            self.breaker_refusals += 1
            raise Overloaded(
                f"circuit breaker open for host {host}", reason="breaker",
                host=host)

    def on_outcome(self, host: int, ok: bool, now: float) -> None:
        """Record one attempt outcome; successes refill the retry budget."""
        self.breaker(host).record(ok, now)
        if ok:
            self.budget(host).refill()

    def spend_retry(self, host: int) -> None:
        """Charge one client-level retry; raises when the budget is dry."""
        b = self.budget(host)
        if not b.spend(b.retry_cost):
            self.budget_refusals += 1
            raise Overloaded(
                f"retry budget exhausted for host {host}", reason="budget",
                host=host)

    def allow_hedge(self, host: int) -> bool:
        """May a read-only probe hedge a second posting?  Hedges ride the
        retry budget (a hedge *is* speculative retry traffic) — no budget,
        no hedge."""
        if not self.budget(host).spend(self.policy.hedge_cost):
            return False
        self.hedges += 1
        return True

    def hedge_threshold(self, host: int) -> float:
        return self.latency(host).threshold()

    def observe_latency(self, host: int, dt: float) -> None:
        self.latency(host).record(dt)

    # ------------------------------------------------------------ telemetry
    def breaker_open(self, host: int) -> bool:
        """Is the breaker for ``host`` currently refusing (OPEN, pre-trial)?
        Read-only: never constructs state for an untracked host."""
        b = self._breakers.get(host)
        return b is not None and b.state != "closed"

    def open_hosts(self) -> List[int]:
        """Hosts whose breakers are not closed — SUSPECT evidence for the
        membership layer (never DEAD: only missed heartbeats may kill)."""
        return sorted(h for h, b in self._breakers.items()
                      if b.state != "closed")

    def breaker_trips(self) -> int:
        return sum(b.trips for b in self._breakers.values())

    def report(self) -> Dict:
        return {
            "breaker_trips": self.breaker_trips(),
            "breaker_refusals": self.breaker_refusals,
            "budget_refusals": self.budget_refusals,
            "hedges": self.hedges,
            "open_hosts": self.open_hosts(),
            "budget_tokens": {h: round(b.tokens, 6)
                              for h, b in sorted(self._budgets.items())},
        }
