"""Contention-adaptive lock inflation policy: when a key is hot enough to
escalate from the packed CAS word to a per-key MCS queue, and when to come
back down.

The packed expiry word is cost-optimal when uncontended — a grant is one
CAS, a renewal is one CAS, an idle key costs nothing.  Under a zipfian hot
key it degenerates: every waiter re-runs the shard critical section per
poll, rCAS per acquire grows with the number of contenders, and grant order
is a lottery (the p99 acquire latency is the geometric tail of losing it).
The queue-based machinery the paper already builds (budgeted MCS cohorts,
``repro_torch.core.mcs``) fixes exactly that regime — FIFO handoff, local
spinning, bounded remote ops — but costs registers and an enqueue per
acquire, which is the wrong trade for the uncontended 99% of the keyspace.

So the mode is *adaptive*, per key (lock inflation, in the HotSpot sense):

* **inflate** when the per-key contention rate over a sliding window
  crosses :attr:`InflationPolicy.inflate_retries` — the home shard flips
  the word's mode bit (a CAS: the readers field goes two's-complement
  negative, see ``coord/table.py``) and hangs a two-cohort split-phase MCS
  queue off the key;
* **deflate** when the rate falls below :attr:`InflationPolicy.deflate_retries`
  *and* the queue has drained *and* the key has been inflated for at least
  :attr:`InflationPolicy.min_inflated` — the hysteresis floor.  A freshly
  deflated key cannot re-inflate for :attr:`InflationPolicy.min_deflated`
  (the refractory gap).  Together the two floors bound the transition
  frequency under any oscillating load to at most one inflate+deflate pair
  per ``min_inflated + min_deflated`` of virtual time (the flapping test
  pins this).

The estimator is **host-side metadata**, like shard placement and the
client slot ledger: it observes protocol events (blocked exclusive
verdicts) and influences *decisions*, but all protocol state lives in the
simulated registers and every word mutation stays a CAS.  Zero cost when
idle is literal: a table built without a policy (``inflation=None``) takes
one attribute check per exclusive acquire and touches nothing else.

Determinism: decisions are pure functions of (event sequence, virtual
clock), both of which the sim engine derives from the seed — two same-seed
runs produce byte-identical inflate/deflate event logs, which the CI
bench-smoke gate diffs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["InflationPolicy", "ContentionEstimator"]


@dataclass(frozen=True)
class InflationPolicy:
    """Thresholds + hysteresis for per-key lock inflation.

    The defaults are sized for the sim workloads' virtual-time scales
    (HOLD = 10us, backoff 20us..2ms): a zipfian hot key at 64x16 clients
    crosses ``inflate_retries`` within its first few milliseconds, a
    uniform workload never gets close, and the two hysteresis floors keep
    a key from flapping faster than once per ~``min_inflated +
    min_deflated`` even under adversarial on/off load.
    """

    # Inflate when this many blocked exclusive attempts land within one
    # sliding ``window`` on a single key.
    inflate_retries: int = 32
    window: float = 1e-3
    # Deflate (at release, queue drained) once the windowed rate is below
    # this — strictly colder than the inflate threshold, the classic
    # two-threshold hysteresis band.
    deflate_retries: int = 4
    # Hysteresis floors: minimum inflated residency, and the refractory
    # gap before a deflated key may inflate again.
    min_inflated: float = 5e-3
    min_deflated: float = 1e-3
    # A parked queue waiter distrusts the queue after this many TTLs
    # without a handoff (dead predecessor / discarded epoch) and falls
    # back to probing the word directly.
    stale_after_ttls: float = 4.0

    def __post_init__(self):
        if self.inflate_retries <= 0 or self.window <= 0:
            raise ValueError("inflate_retries and window must be > 0")
        if self.deflate_retries >= self.inflate_retries:
            raise ValueError(
                "deflate_retries must sit below inflate_retries "
                "(the hysteresis band would be empty or inverted)")
        if self.min_inflated < 0 or self.min_deflated < 0:
            raise ValueError("hysteresis floors must be >= 0")
        if self.stale_after_ttls <= 0:
            raise ValueError("stale_after_ttls must be > 0")


class _KeyHeat:
    """Two-bucket sliding window + per-key transition timestamps."""

    __slots__ = ("bucket", "count", "prev", "inflated_at", "deflated_at")

    def __init__(self, bucket: int):
        self.bucket = bucket    # current window-bucket index
        self.count = 0          # events in the current bucket
        self.prev = 0           # events in the immediately preceding bucket
        self.inflated_at = -1.0
        self.deflated_at = -1.0


class ContentionEstimator:
    """Windowed per-key contention rates + hysteresis clocks.

    One instance per table.  ``note`` is O(1); the rate is the standard
    two-bucket approximation of a sliding window (current bucket plus the
    previous one weighted by its remaining overlap) — monotone in the true
    rate and exact for steady loads, which is all a threshold needs.

    Thread-safe under its own lock for the threaded tables; under the sim
    engine every call sits inside one atomic step, so the lock is
    uncontended and the event order (hence every decision) is seeded.
    """

    _SWEEP = 4096

    def __init__(self, policy: InflationPolicy):
        self.policy = policy
        self._heat: Dict[str, _KeyHeat] = {}
        self._guard = threading.Lock()

    # ------------------------------------------------------------ internals
    def _shift(self, h: _KeyHeat, b: int) -> None:
        if b != h.bucket:
            h.prev = h.count if b == h.bucket + 1 else 0
            h.count = 0
            h.bucket = b

    def _rate(self, h: _KeyHeat, now: float) -> float:
        """Events in the sliding window ending at ``now``."""
        w = self.policy.window
        b = int(now / w)
        self._shift(h, b)
        frac = now / w - b  # how far into the current bucket we are
        return h.count + h.prev * (1.0 - frac)

    def _entry(self, key: str, bucket: int) -> _KeyHeat:
        h = self._heat.get(key)
        if h is None:
            if len(self._heat) >= self._SWEEP:
                cold = [k for k, v in self._heat.items()
                        if v.bucket < bucket - 1 and v.inflated_at < 0]
                for k in cold:
                    del self._heat[k]
            h = self._heat[key] = _KeyHeat(bucket)
        return h

    # ------------------------------------------------------------------ API
    def note(self, key: str, now: float) -> None:
        """Record one contention event (a blocked exclusive attempt)."""
        b = int(now / self.policy.window)
        with self._guard:
            h = self._entry(key, b)
            self._shift(h, b)
            h.count += 1

    def rate(self, key: str, now: float) -> float:
        with self._guard:
            h = self._heat.get(key)
            return self._rate(h, now) if h is not None else 0.0

    def should_inflate(self, key: str, now: float) -> bool:
        """Hot enough, and past the refractory gap since the last deflate."""
        pol = self.policy
        with self._guard:
            h = self._heat.get(key)
            if h is None:
                return False
            if 0.0 <= h.deflated_at and now < h.deflated_at + pol.min_deflated:
                return False
            return self._rate(h, now) >= pol.inflate_retries

    def should_deflate(self, key: str, now: float) -> bool:
        """Cold enough, and past the minimum inflated residency."""
        pol = self.policy
        with self._guard:
            h = self._heat.get(key)
            if h is None:
                return True
            if 0.0 <= h.inflated_at and now < h.inflated_at + pol.min_inflated:
                return False
            return self._rate(h, now) < pol.deflate_retries

    def mark_inflated(self, key: str, now: float) -> None:
        with self._guard:
            h = self._entry(key, int(now / self.policy.window))
            h.inflated_at = now

    def mark_deflated(self, key: str, now: float) -> None:
        with self._guard:
            h = self._heat.get(key)
            if h is not None:
                h.inflated_at = -1.0
                h.deflated_at = now
