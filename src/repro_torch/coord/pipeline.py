"""Futures-based async client pipeline: cross-call doorbell coalescing.

Single table transactions post their WR lists in one
doorbell (:meth:`~repro_torch.core.AsymmetricMemory.post_batch`); this module
generalises that from *per-call* to *cross-call* batching, the load-aware
client direction the RDMA lock-service literature argues for.  An
:class:`AsyncClient` exposes futures-based ``acquire`` / ``renew`` /
``release`` / ``read_optimistic``: each call enqueues a work request on a
per-destination-host queue and returns a :class:`PipelineFuture`; the
queue flushes as **one mixed** ``post_batch`` posting per host — seqlock
read sets, renewal witness CASes and release witness CASes legally share
a WR list because a posting targets one node and executes its entries in
order — so N client calls cost one doorbell instead of N.

Flush triggers (the "scheduling quantum"):

* **size** — a host queue reaching ``flush_ops`` entries flushes at
  enqueue time;
* **deadline** — :meth:`poll` flushes any queue whose oldest entry has
  waited longer than ``quantum`` on the table's (virtual or wall) clock;
* **explicit** — :meth:`flush` drains everything, e.g. at client exit.

Overload semantics are preserved *per op*: remote enqueues pass the
destination's admission gate, per-op absolute deadlines are checked at
enqueue and again at flush (an expired op fails its future with
:class:`~repro_torch.core.DeadlineExceeded` instead of posting doomed work),
and an optimistic read re-enqueued after an unstable snapshot spends the
destination's retry budget exactly like a blocking acquire's retry round.

Ops whose destination is the caller's own host never enqueue: they run
inline at call time (the home class pays zero simulated RDMA either way,
and delaying a free operation buys nothing).  Multi-step operations that
cannot ride a single WR entry (exclusive/shared acquires, slow-path
renews/releases, fallback reads) execute inline at flush time, so the
futures API stays uniform while the fast paths get the batching.

The table's hedged probes also ride the pipeline (:meth:`ride_read`):
a hedge admitted by the retry budget is appended to the probed host's
queue and flushed immediately — it shares the posting with whatever was
queued instead of paying its own doorbell (see ``table._probe``).

Determinism: queues are plain FIFOs, hosts flush in sorted order, and
every time source is the table's injected clock — two same-seed sim runs
produce byte-identical counters (the CI ``read-pipeline-smoke`` gate).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import DeadlineExceeded, Process, RemoteTimeout

from .table import (LeaseMode, Lease, ShardedLockTable, _OPT_ATTEMPTS,
                    _enc)


class PipelineFuture:
    """Resolution slot for one pipelined op.

    Not thread-aware: a pipeline belongs to one coordination process (the
    spawn contract makes a pid single-threaded), so the future resolves
    during that process's own ``poll``/``flush`` calls.  ``result()`` on
    an unresolved future raises — flush first.
    """

    __slots__ = ("_done", "_value", "_exc")

    def __init__(self):
        self._done = False
        self._value = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            raise RuntimeError(
                "pipeline future unresolved: flush() or poll() the client")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self) -> Optional[BaseException]:
        return self._exc if self._done else None

    def _resolve(self, value) -> None:
        self._done = True
        self._value = value

    def _fail(self, exc: BaseException) -> None:
        self._done = True
        self._exc = exc


class _Op:
    """One queued work request (kind: read | renew | release | acquire |
    rawread)."""

    __slots__ = ("kind", "key", "lease", "ttl", "mode", "deadline",
                 "future", "attempts", "reg", "enq_at")

    def __init__(self, kind, future, enq_at, key=None, lease=None, ttl=None,
                 mode=None, deadline=None, reg=None):
        self.kind = kind
        self.future = future
        self.enq_at = enq_at
        self.key = key
        self.lease = lease
        self.ttl = ttl
        self.mode = mode
        self.deadline = deadline
        self.reg = reg
        self.attempts = 0


class AsyncClient:
    """Per-process async pipeline over one :class:`ShardedLockTable`.

    ``flush_ops`` is the size trigger (a host queue this long flushes at
    enqueue); ``quantum`` is the deadline trigger (``poll`` flushes any
    queue whose head has waited this long).  Both run on the table's
    injected clock.
    """

    def __init__(self, table: ShardedLockTable, p: Process,
                 flush_ops: int = 8, quantum: float = 100e-6):
        if flush_ops <= 0:
            raise ValueError("flush_ops must be > 0")
        self.table = table
        self.p = p
        self.flush_ops = flush_ops
        self.quantum = quantum
        self._q: Dict[int, List[_Op]] = {}
        #: flushes = postings sent; flushed_ops = ops resolved off queues;
        #: inline_ops = multi-step ops run at flush; hedge_rides = hedges
        #: that shared a posting with queued work.
        self.stats = {"flushes": 0, "flushed_ops": 0, "inline_ops": 0,
                      "reads_batched": 0, "renews_batched": 0,
                      "releases_batched": 0, "hedge_rides": 0}
        table.attach_pipeline(p, self)

    # ------------------------------------------------------------- enqueue
    def _home_of_key(self, key: str) -> int:
        return self.table.shards[self.table.shard_of(key)].home_host

    def _enq(self, host: int, op: _Op) -> None:
        q = self._q.setdefault(host, [])
        q.append(op)
        if len(q) >= self.flush_ops:
            self._flush_host(host)

    def _gate(self, host: int, fut: PipelineFuture) -> bool:
        """Admission at enqueue: a remote op whose destination sheds
        fails its future immediately — zero fabric ops, same posture as
        try_acquire's gate."""
        ctl = self.table.overload
        if ctl is None or self.p.node == host:
            return True
        try:
            ctl.admit_remote(host, self.table.clock())
        except Exception as exc:  # Overloaded (typed in repro_torch.core)
            fut._fail(exc)
            return False
        return True

    def read_optimistic(self, key: str,
                        deadline: Optional[float] = None) -> PipelineFuture:
        """Pipelined seqlock read; resolves to ``(value, publish_token)``,
        or to ``None`` when a live writer holds the key (re-issue after a
        backoff — the table never waits out a holder internally).

        Home keys resolve inline (0 RDMA, nothing to batch); remote keys
        enqueue one 4-entry WR read set that rides the host's next flush
        — N reads to one host cost ONE doorbell and zero CAS.
        """
        fut = PipelineFuture()
        home = self._home_of_key(key)
        if self.p.node == home:
            try:
                fut._resolve(self.table.read_optimistic(
                    self.p, key, deadline=deadline))
            except Exception as exc:
                fut._fail(exc)
            return fut
        if self._gate(home, fut):
            self._enq(home, _Op("read", fut, self.table.clock(), key=key,
                                deadline=deadline))
        return fut

    def acquire(self, key: str, ttl: float,
                mode: LeaseMode = LeaseMode.EXCLUSIVE,
                deadline: Optional[float] = None) -> PipelineFuture:
        """Pipelined non-blocking acquire; resolves to a Lease or None.

        A lease grant is a multi-step transaction (CS engagement or a
        shared join loop), so it executes inline at flush time — the
        pipeline contributes latency batching and the shared admission
        gate, not WR merging, for this op kind.
        """
        fut = PipelineFuture()
        home = self._home_of_key(key)
        if self.p.node == home:
            try:
                fut._resolve(self.table.try_acquire(self.p, key, ttl,
                                                    mode=mode))
            except Exception as exc:
                fut._fail(exc)
            return fut
        # No enqueue-time gate: try_acquire runs the admission gate
        # itself at flush time (gating here too would consume a half-open
        # breaker trial twice for one attempt).
        self._enq(home, _Op("acquire", fut, self.table.clock(), key=key,
                            ttl=ttl, mode=mode, deadline=deadline))
        return fut

    def renew(self, lease: Lease, ttl: Optional[float] = None,
              deadline: Optional[float] = None) -> PipelineFuture:
        """Pipelined renew; resolves to the renewed Lease or None.

        An EXCLUSIVE renewal is a single witness CAS, so it rides the
        flush posting as one WR; SHARED (multi-step) renews run inline at
        flush.
        """
        fut = PipelineFuture()
        home = self.table.shards[lease.shard].home_host
        if self.p.node == home:
            try:
                fut._resolve(self.table.renew(self.p, lease, ttl,
                                              deadline=deadline))
            except Exception as exc:
                fut._fail(exc)
            return fut
        if self._gate(home, fut):
            self._enq(home, _Op("renew", fut, self.table.clock(),
                                lease=lease, ttl=ttl, deadline=deadline))
        return fut

    def release(self, lease: Lease,
                deadline: Optional[float] = None) -> PipelineFuture:
        """Pipelined release; resolves to True iff the lease was current.

        EXCLUSIVE fast-path releases ride the flush as one witness-CAS WR
        (so a release shares a doorbell with queued reads/renews); misses
        and SHARED releases settle inline through the table's slow paths.
        """
        fut = PipelineFuture()
        home = self.table.shards[lease.shard].home_host
        if self.p.node == home:
            try:
                fut._resolve(self.table.release(self.p, lease))
            except Exception as exc:
                fut._fail(exc)
            return fut
        if self._gate(home, fut):
            self._enq(home, _Op("release", fut, self.table.clock(),
                                lease=lease, deadline=deadline))
        return fut

    # ------------------------------------------------------------ flushing
    def pending(self) -> int:
        return sum(len(q) for q in self._q.values())

    def poll(self) -> None:
        """Deadline-triggered flush: drain every host queue whose oldest
        entry has waited at least one quantum (or that hit the size
        trigger between enqueues)."""
        now = self.table.clock()
        for host in sorted(self._q):
            q = self._q.get(host)
            if q and (len(q) >= self.flush_ops
                      or now - q[0].enq_at >= self.quantum):
                self._flush_host(host)

    def flush(self) -> None:
        """Explicit flush of every host queue (e.g. client shutdown)."""
        for host in sorted(self._q):
            self._flush_host(host)

    def sync(self, fut: PipelineFuture):
        """Settle ``fut`` now: flush if it is still queued, then return
        its result (re-raising its failure) — the bridge for blocking
        call sites like ``BatchAdmission.keepalive``."""
        if not fut.done():
            self.flush()
        return fut.result()

    def ride_read(self, reg):
        """Hedge transport (see ``table._probe``): append one idempotent
        read for ``reg`` to its host's queue and flush that host NOW —
        the hedge shares the posting with any queued work instead of
        posting its own doorbell.  Blocking: returns the read value.
        The caller's own op accounting covers the posting (account=False),
        so the hedge is never double-counted."""
        fut = PipelineFuture()
        host = reg.node
        if self._q.get(host):
            self.stats["hedge_rides"] += 1
        self._q.setdefault(host, []).append(
            _Op("rawread", fut, self.table.clock(), reg=reg))
        self._flush_host(host, account=False)
        return fut.result()

    def _flush_host(self, host: int, account: bool = True) -> None:
        q = self._q.pop(host, None)
        if not q:
            return
        table, p = self.table, self.p
        now = table.clock()
        wrs: List[tuple] = []
        spans: List[Tuple[_Op, int, object]] = []  # (op, n_wrs, ctx)
        inline: List[_Op] = []
        requeue: List[_Op] = []
        for op in q:
            if op.deadline is not None and now >= op.deadline:
                self._fail_deadline(op)
                continue
            if op.kind == "read":
                shard = table.shards[table.shard_of(op.key)]
                if shard.home_host != host:
                    inline.append(op)  # re-homed mid-queue: settle inline
                    continue
                st = table._key_state(shard, op.key)
                wrs.extend(table._opt_read_wrs(st))
                spans.append((op, 4, shard))
            elif op.kind == "renew" and self._fast_renewable(op, now):
                lease, ttl = op.lease, (op.ttl if op.ttl is not None
                                        else op.lease.ttl)
                st = table._key_state(table.shards[lease.shard], lease.key)
                witness = lease.witness()
                wrs.append(("cas", st.expires, witness,
                            (lease.token, _enc(0, lease.inflated),
                             now + ttl)))
                spans.append((op, 1, (witness, now + ttl, ttl)))
            elif op.kind == "release" and self._fast_releasable(op):
                lease = op.lease
                st = table._key_state(table.shards[lease.shard], lease.key)
                witness = lease.witness()
                wrs.append(("cas", st.expires, witness,
                            (lease.token, _enc(0, lease.inflated), 0.0)))
                spans.append((op, 1, witness))
            elif op.kind == "rawread":
                wrs.append(("read", op.reg))
                spans.append((op, 1, None))
            else:
                inline.append(op)
        if wrs:
            snap = p.counts.as_tuple()
            vals = None
            try:
                vals = table.mem.post_batch(p, wrs)
            except RemoteTimeout as exc:
                for op, _n, _ctx in spans:
                    op.future._fail(exc)
            finally:
                if account:
                    # One merged posting, accounted once — to the first
                    # spanned op's shard (same host, same class; rawread
                    # hedges are covered by their caller's own window).
                    ashard = next((c for o, _n, c in spans
                                   if o.kind == "read"), None)
                    if ashard is None:
                        for o, _n, _c in spans:
                            if o.lease is not None:
                                ashard = table.shards[o.lease.shard]
                                break
                    if ashard is not None:
                        table._account(ashard, p, snap, LeaseMode.SHARED)
            self.stats["flushes"] += 1
            if vals is not None:
                off = 0
                for op, n, ctx in spans:
                    chunk = vals[off:off + n]
                    off += n
                    self._demux(op, chunk, ctx, now, requeue)
                self.stats["flushed_ops"] += len(spans)
        for op in inline:
            self._run_inline(op)
            self.stats["inline_ops"] += 1
        for op in requeue:
            self._enq(host, op)

    # ------------------------------------------------------------- helpers
    def _fast_renewable(self, op: _Op, now: float) -> bool:
        lease = op.lease
        return (lease.mode == LeaseMode.EXCLUSIVE
                and now < lease.expires_at)

    def _fast_releasable(self, op: _Op) -> bool:
        return op.lease.mode == LeaseMode.EXCLUSIVE

    def _fail_deadline(self, op: _Op) -> None:
        table = self.table
        shard = (table.shards[op.lease.shard] if op.lease is not None
                 else table.shards[table.shard_of(op.key)])
        with shard._meta:
            shard.deadline_exceeded += 1
        op.future._fail(DeadlineExceeded(
            f"pipelined {op.kind} of "
            f"{(op.key or op.lease.key)!r}: deadline passed"))

    def _demux(self, op: _Op, chunk: list, ctx, now: float,
               requeue: List[_Op]) -> None:
        table, p = self.table, self.p
        if op.kind == "rawread":
            op.future._resolve(chunk[0])
            return
        if op.kind == "read":
            shard = ctx
            w1, payload, w2, barrier = chunk
            verdict, out = table._opt_read_verdict(now, w1, payload, w2,
                                                   barrier)
            if verdict == "ok":
                with shard._meta:
                    shard.opt_reads += 1
                self.stats["reads_batched"] += 1
                op.future._resolve(out)
                return
            with shard._meta:
                if verdict == "forward":
                    shard.opt_read_fwd += 1
                else:
                    shard.opt_read_retries += 1
            op.attempts += 1
            if op.attempts >= _OPT_ATTEMPTS:
                # Bounded failures: degrade to the shared-lease fallback,
                # inline (multi-step), same as the blocking read path.
                # A refused join (live writer) resolves the future to
                # None — the caller re-issues, same retry contract as
                # the blocking read and try_acquire.
                with shard._meta:
                    shard.opt_read_fallbacks += 1
                try:
                    op.future._resolve(table._opt_read_fallback(
                        p, op.key, 1.0))
                except Exception as exc:
                    op.future._fail(exc)
                return
            # Retry rides the NEXT flush; each re-enqueue spends the
            # destination's retry budget like a blocking retry round.
            ctl = table.overload
            if ctl is not None:
                try:
                    ctl.spend_retry(shard.home_host)
                except Exception as exc:
                    op.future._fail(exc)
                    return
            op.enq_at = now
            requeue.append(op)
            return
        if op.kind == "renew":
            witness, new_exp, ttl = ctx
            lease = op.lease
            if chunk[0] == witness:
                shard = table.shards[lease.shard]
                with shard._meta:
                    shard.fast_renews += 1
                self.stats["renews_batched"] += 1
                op.future._resolve(Lease(
                    lease.key, lease.shard, lease.holder_pid, lease.token,
                    new_exp, ttl, LeaseMode.EXCLUSIVE, lease.inflated))
            else:
                # Witness missed inside the posting: settle through the
                # table's fully validated slow path.
                try:
                    op.future._resolve(table.renew(p, lease, op.ttl))
                except Exception as exc:
                    op.future._fail(exc)
            return
        if op.kind == "release":
            witness = ctx
            lease = op.lease
            if chunk[0] == witness:
                shard = table.shards[lease.shard]
                with shard._meta:
                    shard.fast_releases += 1
                self.stats["releases_batched"] += 1
                if lease.inflated:
                    st = table._key_state(shard, lease.key)
                    table._inflated_handoff(p, shard, st, lease.key, lease)
                op.future._resolve(True)
            else:
                try:
                    op.future._resolve(table.release(p, lease))
                except Exception as exc:
                    op.future._fail(exc)
            return
        raise AssertionError(f"unknown op kind {op.kind!r}")

    def _run_inline(self, op: _Op) -> None:
        table, p = self.table, self.p
        try:
            if op.kind == "acquire":
                op.future._resolve(table.try_acquire(p, op.key, op.ttl,
                                                     mode=op.mode))
            elif op.kind == "read":
                op.future._resolve(table.read_optimistic(
                    p, op.key, deadline=op.deadline))
            elif op.kind == "renew":
                op.future._resolve(table.renew(p, op.lease, op.ttl,
                                               deadline=op.deadline))
            elif op.kind == "release":
                op.future._resolve(table.release(p, op.lease))
            else:
                raise AssertionError(f"unknown op kind {op.kind!r}")
        except Exception as exc:
            op.future._fail(exc)
