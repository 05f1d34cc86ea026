"""The sharded lock table in action, over the PyTorch port's control plane
(``repro_torch.coord``, the JAX package's copied module for module):
checkpoint-writer leases with fencing.  The port's counterpart of
``examples/lock_service.py``; it touches no tensor and runs on the host.

Four hosts run training shards over one sharded asymmetric lock table — each
host is the zero-fabric "local class" for its shard of the keyspace.  Every
epoch the hosts race for the writer lease; the holder **keepalives the lease
through the renewal fast path** while "writing" (a fencing-token-checked CAS
on the expiry register — zero RDMA ops when the writer is local to the key's
shard, exactly one rCAS when remote), then writes the checkpoint with its
fencing token.  At epoch 3 the winning writer *crashes* while holding the
lease: the lease expires instead of wedging the table, a new writer is
granted a larger fencing token, and the store rejects the zombie's late
write.  A batched multi-key acquire then updates several manifest entries
atomically, in the table's deadlock-free global key order — holding each
shard's ALock once per shard group.

A second act demos the **mode-aware stack**: a fleet of home-host readers
share one manifest key through SHARED leases — every join is a single
machine CAS, zero RDMA ops — while a remote writer periodically takes the
key EXCLUSIVE (the writer-intent barrier drains the cohort, bounding its
wait), printing the per-mode per-class operation costs at the end.

    PYTHONPATH=src python examples/lock_service_torch.py
"""

import threading
import time
import traceback

from repro_torch.coord import CoordinationService, LeaseMode

EPOCHS = 5
CRASH_EPOCH = 3
TTL = 0.15  # writer lease TTL: a crashed writer delays the job at most this
KEEPALIVES = 3  # fast-path renewals per checkpoint write


class CheckpointStore:
    """A fenced store: rejects writes whose token is older than the best seen
    (how a real block store survives a zombie writer, Lamport/Burrows style)."""

    def __init__(self):
        self.best_token = {}  # per checkpoint object: tokens are per-key
        self.writes = []
        self.rejected = []
        self._mu = threading.Lock()

    def write(self, epoch, host, token):
        with self._mu:
            if token < self.best_token.get(epoch, -1):
                self.rejected.append((epoch, host, token))
                return False
            self.best_token[epoch] = token
            self.writes.append((epoch, host, token))
            return True


def reader_fleet_demo():
    """N home-host readers at 0 RDMA ops alongside one remote writer.

    The readers live on the key's home host and join its reader cohort with
    single machine CASes (the paper's local class: the fabric is never
    touched).  The remote writer pays a bounded number of one-sided ops per
    exclusive grant, and its wait is bounded by the drain barrier no matter
    how hot the reader loop runs.
    """
    READERS = 3
    READS_EACH = 40
    WRITES = 3
    svc = CoordinationService(num_hosts=2, init_budget=3, num_shards=4)
    # A key homed on host 0: readers there are the zero-RDMA local class.
    key = next(f"manifest/hot/{i}" for i in range(10_000)
               if svc.home_of(f"manifest/hot/{i}") == 0)
    stats = {"reads": 0, "writes": 0, "writer_waits": []}
    mu = threading.Lock()
    stop = threading.Event()
    failures = []

    def reader(i):
        p = svc.host_process(0)  # home host: local class for `key`
        snap = p.counts.snapshot()
        n = 0
        while n < READS_EACH and not stop.is_set():
            lease = svc.try_acquire(p, key, ttl=0.5, mode=LeaseMode.SHARED)
            if lease is None:
                time.sleep(0.001)  # a writer holds (or drains) the key
                continue
            n += 1
            svc.release(p, lease)
        d = p.counts.delta(snap)
        assert d.rdma_ops == 0, f"home reader paid fabric ops: {vars(d)}"
        with mu:
            stats["reads"] += n

    def writer():
        p = svc.host_process(1)  # remote to the key's home shard
        for _ in range(WRITES):
            if stop.is_set():
                return
            t0 = time.monotonic()
            lease = svc.acquire(p, key, ttl=0.5, timeout=10.0)
            with mu:
                stats["writer_waits"].append(time.monotonic() - t0)
                stats["writes"] += 1
            time.sleep(0.002)  # "write" under the exclusive lease
            svc.release(p, lease)
            time.sleep(0.004)  # let the readers flood back in

    def run(fn, *args):
        try:
            fn(*args)
        except Exception:
            failures.append(traceback.format_exc())
            stop.set()

    ts = [threading.Thread(target=run, args=(reader, i))
          for i in range(READERS)] + [threading.Thread(target=run, args=(writer,))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not failures, "\n".join(failures)
    assert stats["reads"] == READERS * READS_EACH
    assert stats["writes"] == WRITES
    max_wait = max(stats["writer_waits"])
    assert max_wait < 5.0, f"writer starved by the reader flood: {max_wait}s"

    print("\nreader fleet (shared leases) vs one remote writer (exclusive):")
    print(f"  {stats['reads']} shared reads by {READERS} home readers, "
          f"{stats['writes']} exclusive writes; "
          f"writer max wait {max_wait * 1e3:.1f} ms (drain-bounded)")
    mode_totals = svc.table.mode_class_totals()
    print(f"  {'mode':>10} {'class':>6} {'rdma ops':>8} {'local ops':>9} "
          f"{'doorbells':>9}")
    for mode in LeaseMode:
        for cls, cname in ((0, "LOCAL"), (1, "REMOTE")):
            c = mode_totals[mode][cls]
            print(f"  {mode.label:>10} {cname:>6} {c.rdma_ops:>8} "
                  f"{c.local_ops:>9} {c.remote_doorbell:>9}")
    assert mode_totals[LeaseMode.SHARED][0].rdma_ops == 0
    assert mode_totals[LeaseMode.EXCLUSIVE][0].rdma_ops == 0
    rows = svc.telemetry()
    print(f"  shared joins: {sum(r['shared_joins'] for r in rows)}, "
          f"intent blocks (drain): {sum(r['intent_blocks'] for r in rows)}, "
          f"exclusive grants: {sum(r['grants_exclusive'] for r in rows)}")
    print("OK: home readers paid 0 RDMA ops; the remote writer drained the "
          "cohort within its bounded wait.")


def main():
    svc = CoordinationService(num_hosts=4, init_budget=3, num_shards=8)
    store = CheckpointStore()
    gate = threading.Barrier(4)  # epoch alignment between simulated hosts
    zombie = {}
    failures = []
    keepalives = []  # (host, key_home, renewals, rdma_delta, local_delta)
    keep_mu = threading.Lock()

    def writer_keepalive(p, h, epoch, lease):
        """Hold the writer lease alive through the renewal fast path while
        the checkpoint is 'written', and account its per-class cost."""
        snap = p.counts.snapshot()
        for _ in range(KEEPALIVES):
            lease = svc.renew(p, lease)
            assert lease is not None, "live writer lost its own lease"
        d = p.counts.delta(snap)
        home = svc.home_of(lease.key)
        if h == home:  # the paper's local class: renewals must be fabric-free
            assert d.rdma_ops == 0, vars(d)
        else:
            # Remote class: one rCAS per fast-path renewal.  A renewal can
            # legitimately fall to the (bounded) ALock slow path if a
            # scheduler stall eats the short demo TTL, so bound rather than
            # pin — the table prints the realised fast-path count below.
            assert KEEPALIVES <= d.rdma_ops <= 12 * KEEPALIVES, vars(d)
        with keep_mu:
            keepalives.append((h, home, KEEPALIVES, d.rdma_ops, d.local_ops))
        return lease

    def gate_wait():
        # Timeout so a dead peer breaks the barrier (BrokenBarrierError in
        # the survivors) instead of hanging the demo forever.
        gate.wait(timeout=15)

    def host(h):
        p = svc.host_process(h)
        for epoch in range(1, EPOCHS + 1):
            gate_wait()
            lease = svc.try_acquire(p, f"ckpt-writer/{epoch}", ttl=TTL)
            if lease is not None:
                if epoch == CRASH_EPOCH and not zombie:
                    # Crash while holding the lease: no release, write later.
                    zombie[epoch] = (h, lease)
                else:
                    # Keepalive while "writing": the renewal fast path keeps
                    # the slot alive without ever taking the shard ALock.
                    lease = writer_keepalive(p, h, epoch, lease)
                    assert store.write(epoch, h, lease.token)
            gate_wait()
            if epoch == CRASH_EPOCH and zombie.get(epoch, (None,))[0] == h:
                # The rest of the fleet waits out the TTL, re-elects, and a
                # new writer (larger fencing token) covers the epoch...
                time.sleep(TTL)
            gate_wait()
            if epoch == CRASH_EPOCH:
                zh, zlease = zombie[epoch]
                if h != zh:
                    retry = svc.try_acquire(p, f"ckpt-writer/{epoch}", ttl=TTL)
                    if retry is not None:
                        store.write(epoch, h, retry.token)
                elif h == zh:
                    time.sleep(TTL / 2)  # stay dead while others re-elect
            gate_wait()
            if epoch == CRASH_EPOCH and zombie.get(epoch, (None,))[0] == h:
                # ...and the zombie's late write must bounce off the fence.
                zh, zlease = zombie[epoch]
                assert not store.write(epoch, zh, zlease.token), "fencing failed"

        # Batched manifest update: every host updates its own 3 entries in
        # one all-or-nothing multi-key acquisition (deadlock-free order).
        keys = [f"manifest/host{h}/part{i}" for i in range(3)] + ["manifest/epoch"]
        leases = svc.acquire_batch(p, keys, ttl=5.0, timeout=30.0)
        assert svc.release_batch(p, leases) == len(leases)

    def run_host(h):
        try:
            host(h)
        except Exception:  # surface instead of hanging peers at the barrier
            failures.append((h, traceback.format_exc()))
            gate.abort()

    ts = [threading.Thread(target=run_host, args=(h,)) for h in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not failures, "host thread failed:\n" + "\n".join(tb for _, tb in failures)

    print("fenced checkpoint writes (epoch, host, token):")
    for row in store.writes:
        print("   ", row)
    print("rejected zombie writes:", store.rejected)
    epochs_written = sorted({e for e, _, _ in store.writes})
    assert epochs_written == list(range(1, EPOCHS + 1)), epochs_written
    assert store.rejected, "the crashed writer's stale token was not exercised"

    print("\nwriter keepalives (renewal fast path; per-class op cost):")
    print(f"  {'host':>4} {'key home':>8} {'renewals':>8} {'rdma ops':>8} "
          f"{'local ops':>9}  class")
    for h, home, n, rdma, local in sorted(keepalives):
        cls = "LOCAL (0 RDMA)" if h == home else "REMOTE (1 rCAS each)"
        print(f"  {h:>4} {home:>8} {n:>8} {rdma:>8} {local:>9}  {cls}")
    assert keepalives, "no writer exercised the keepalive loop"
    fast = sum(r["fast_renews"] for r in svc.telemetry())
    assert fast > 0, "no renewal rode the fast path"
    print(f"  table fast-path renewals: {fast} (no shard ALock taken)")

    print("\nper-shard telemetry (home host is the zero-RDMA local class):")
    print(f"  {'shard':>5} {'home':>4} {'keys':>4} {'grants':>6} "
          f"{'local rdma':>10} {'remote rdma':>11}")
    for row in svc.telemetry():
        print(f"  {row['shard']:>5} {row['home_host']:>4} {row['keys']:>4} "
              f"{row['grants']:>6} {row['local'].rdma_ops:>10} "
              f"{row['remote'].rdma_ops:>11}")
        assert row["local"].rdma_ops == 0, "local class must never touch the fabric"
    print("\nOK: one fenced writer per epoch; a crashed holder's lease expired "
          "instead of wedging the shard; local classes used 0 RDMA ops.")

    reader_fleet_demo()


if __name__ == "__main__":
    main()
