"""Batched serving: prefill a prompt batch, then greedy decode.

Port of ``repro/launch/serve.py``.  ``serve`` is the library entry (used by
``examples/serve_batch_torch.py`` and ``chip_smoke.py``); ``main`` is the CLI,
which, like the reference's, has no mesh flags.  On a ``(pod, data, model)``
mesh every rank calls ``serve`` inside one process group: the request's rows
go on ``(pod, data)``, the parameters and KV caches on ``model`` by the rules
(``sharding/``), the last-token logits are gathered over ``model`` for the
greedy argmax, and every rank returns the whole batch's tokens.

Request-batch **admission** is a lock-table client
(:class:`BatchAdmission`, the reference's class over the port's own copy of
the control plane): each concurrent batch slot is a lease in the sharded
asymmetric lock table, so a crashed batch worker's slot expires after its
TTL, the fencing token identifies the admission, and the serving host (the
table's local class) pays zero simulated RDMA operations on its own
admission path.  Off by default (``admission_slots=0``): the bare path then
runs exactly as without it.  Two rules keep a lease honest on the card: the
kernels are built and loaded before the batch is admitted, so an nvcc build
never runs down the TTL, and a keepalive follows only decode steps that the
card has finished, since the loop otherwise keeps its tokens on the device
and waits for nothing.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..configs import ShapeConfig, get_config
from ..coord import CoordinationService, LeaseMode, RecoverableClient
from ..core import Overloaded
from ..kernels import ops
from ..models import Model, input_specs, rank_inputs
from ..sharding.shard import gather_rows
from .mesh import make_mesh


class BatchAdmission:
    """Admission control for request batches, as a lock-table client.

    Each of ``num_slots`` concurrent batch slots is a key in the sharded lock
    table; admitting a batch means taking a lease on a free slot.  The TTL is
    the worst-case batch walltime: a worker that dies mid-batch stops renewing
    and its slot re-opens at expiry, so capacity can never leak away.  The
    lease's fencing token travels with the batch for downstream accounting
    (e.g. a KV-cache pool can reject a zombie batch's writes).

    **Read slots vs write slots** (the mode-aware split): mutating batches
    (decode/prefill that write KV state) take EXCLUSIVE leases on the write
    slots as before, while read-only work — health probes, stats scrapes,
    cache-warm scans — shares ``read_slots`` *read lanes* through SHARED
    leases (:meth:`admit_read`): any number of readers join a lane with a
    single CAS and zero simulated RDMA ops on the serving host, so read
    traffic never queues behind (or consumes) batch capacity.  A maintenance
    operation that must quiesce a lane's readers takes an EXCLUSIVE lease on
    it (:meth:`quiesce`): the table's writer-intent barrier stops new joins,
    the cohort drains within one TTL, and readers resume the moment the
    maintenance lease is released.

    **Named workers and crash recovery**: a server thread that admits under a
    ``worker`` name goes through a ledgered
    :class:`~repro_torch.coord.RecoverableClient`, so every slot admission leaves a
    durable trail.  When a worker thread dies mid-batch and its supervisor
    starts a replacement, the new thread calls :meth:`recover` with the same
    name: the predecessor's ledger replays and every still-valid slot lease
    is *reclaimed* via the fencing-checked CAS — the replacement resumes the
    batch (same slot, same fencing token) instead of waiting out the TTL or
    double-granting capacity.  Anonymous admissions (no ``worker``) keep the
    bare fast path.
    """

    def __init__(self, num_slots: int = 4, ttl: float = 30.0,
                 svc: Optional[CoordinationService] = None,
                 read_slots: int = 0):
        if num_slots <= 0:
            raise ValueError("num_slots must be > 0")
        if read_slots < 0:
            raise ValueError("read_slots must be >= 0")
        # Single-host table by default: the serving host is the local class
        # for every shard, so admissions cost zero simulated RDMA ops.
        self.svc = svc or CoordinationService(
            num_hosts=1, num_shards=num_slots + read_slots)
        self.num_slots = num_slots
        self.read_slots = read_slots
        self.ttl = ttl
        self._tls = threading.local()
        # Ledgered clients by worker name (the identity that survives a
        # thread death).  A name is bound to one live thread at a time;
        # rebinding happens through recover().
        self._workers: Dict[str, RecoverableClient] = {}
        self._wlock = threading.Lock()
        # One async pipeline per server thread: anonymous
        # keepalives ride it, and the table's hedged probes from that
        # thread share its flush postings.  Kept in a list too, so
        # stats() can aggregate across threads.
        self._pipes = []
        #: EXCLUSIVE admissions refused at the gate by the overload layer.
        self.sheds = 0

    def _proc(self):
        # One coordination Process per server thread: the MCS queue keys its
        # descriptors by pid, so sharing one pid across threads would corrupt
        # the shard ALocks (service.host_process: "call once per host thread").
        p = getattr(self._tls, "p", None)
        if p is None:
            p = self._tls.p = self.svc.host_process(0)
        return p

    def _pipe(self):
        # This thread's AsyncClient over the admission table.  On the
        # default single-host table every op is home-class and resolves
        # inline (identical semantics, zero RDMA); over a multi-host
        # service, remote keepalives coalesce into one posting per flush.
        pl = getattr(self._tls, "pipe", None)
        if pl is None:
            pl = self._tls.pipe = self.svc.async_client(self._proc())
            with self._wlock:
                self._pipes.append(pl)
        return pl

    def _worker(self, worker: str) -> RecoverableClient:
        with self._wlock:
            rc = self._workers.get(worker)
            if rc is None:
                rc = self._workers[worker] = self.svc.recoverable(
                    f"serve/{worker}", self._proc())
            return rc

    def recover(self, worker: str):
        """Crash-restart re-entry for a named worker thread.

        The replacement thread (same ``worker`` name, fresh coordination
        process) replays its predecessor's ledger and reclaims every slot
        lease that is still valid — fencing-checked, so a lease the table
        already re-granted comes back as lost, never double-held.  Returns
        the reclaimed leases; the worker resumes those batches (or
        ``complete``\\ s them) under the original fencing tokens.
        """
        client, reclaimed = self.svc.restart(f"serve/{worker}", self._proc())
        with self._wlock:
            self._workers[worker] = client
        return reclaimed

    def _admission_gate(self, key: str) -> None:
        """Brownout shedding: refuse an EXCLUSIVE admission fast when the
        overload layer already knows the slot's home is in trouble (open
        circuit breaker, or a retry budget too dry to fund even one retry
        round).  Read-lane admissions (:meth:`admit_read`) never come
        through here — shared-mode reads keep flowing while exclusive
        admits shed, which is the brownout contract.  A no-op when the
        service carries no :class:`~repro_torch.coord.OverloadPolicy`."""
        ctl = self.svc.table.overload
        if ctl is None:
            return
        home = self.svc.home_of(key)
        if ctl.breaker_open(home):
            self.sheds += 1
            raise Overloaded(
                f"admission shed: breaker open for host {home}",
                reason="breaker", host=home)
        b = ctl.budget(home)
        if b.tokens < b.retry_cost:
            self.sheds += 1
            raise Overloaded(
                f"admission shed: retry budget dry for host {home}",
                reason="budget", host=home)

    def admit(self, timeout: Optional[float] = None,
              worker: Optional[str] = None,
              deadline: Optional[float] = None):
        """Take an EXCLUSIVE lease on any free write slot (round-robin scan,
        then block).

        The deadline and backoff run on the coordination service's injected
        clock/sleep pair, so an admission gate over a sim-backed (or
        fake-clock) table times out in that table's time base instead of
        wall time.  ``deadline`` is the absolute form (the earlier of the
        two wins); under overload control, admissions shed fast at the gate
        instead of scanning a slot list they cannot win (see
        :meth:`_admission_gate`).

        With a ``worker`` name the admission is ledgered (see
        :meth:`recover`); anonymous admissions take the bare path.
        """
        clock, sleep = self.svc.table.clock, self.svc.table.sleep
        if timeout is not None:
            tdl = clock() + timeout
            deadline = tdl if deadline is None else min(deadline, tdl)
        rc = self._worker(worker) if worker is not None else None
        while True:
            for s in range(self.num_slots):
                key = f"serve/slot{s}"
                self._admission_gate(key)
                try:
                    if rc is not None:
                        lease = rc.try_acquire(key, self.ttl)
                    else:
                        lease = self.svc.try_acquire(self._proc(), key,
                                                     self.ttl)
                except Overloaded:
                    self.sheds += 1
                    raise
                if lease is not None:
                    return lease
            if deadline is not None and clock() > deadline:
                raise TimeoutError(f"no admission slot free in {timeout}s")
            sleep(0.002)  # back off: a full scan found no free slot

    def admit_read(self, timeout: Optional[float] = None):
        """Join a read lane with a SHARED lease (a single CAS; readers
        stack, so this only ever blocks while a quiesce drains the lanes).

        Requires ``read_slots > 0``.  The lane is chosen round-robin so
        concurrent readers spread their cohort CASes across lanes.
        Complete (and keepalive) a shared admission **on the thread that
        admitted it**: each server thread is its own coordination process,
        and the table's cohort-slot ledger is per process.  (Exclusive
        admissions are witness CASes and may be completed from any thread.)
        """
        if self.read_slots <= 0:
            raise ValueError("admit_read() needs read_slots > 0")
        clock, sleep = self.svc.table.clock, self.svc.table.sleep
        # Deliberately NOT gated by _admission_gate: the brownout contract
        # is that shared-mode reads keep flowing while exclusive admits
        # shed (a reader join is one CAS, zero RDMA on the serving host —
        # refusing it buys nothing).
        deadline = None if timeout is None else clock() + timeout
        p = self._proc()
        while True:
            for s in range(self.read_slots):
                lane = (p.pid + s) % self.read_slots
                lease = self.svc.try_acquire(
                    p, f"serve/readlane{lane}", self.ttl,
                    mode=LeaseMode.SHARED)
                if lease is not None:
                    return lease
            if deadline is not None and clock() > deadline:
                raise TimeoutError(f"no read lane joinable in {timeout}s")
            sleep(0.002)  # every lane is quiescing: wait out the drain

    def quiesce(self, lane: int = 0, timeout: Optional[float] = None):
        """Take an EXCLUSIVE lease on a read lane — the maintenance path.

        Arms the table's writer-intent barrier on the lane: no new readers
        join, the live cohort drains within one TTL, and the returned lease
        excludes every reader until it is released (``complete``).
        """
        if not (0 <= lane < self.read_slots):
            raise ValueError(f"lane {lane} out of range")
        clock, sleep = self.svc.table.clock, self.svc.table.sleep
        deadline = None if timeout is None else clock() + timeout
        while True:
            lease = self.svc.try_acquire(self._proc(), f"serve/readlane{lane}",
                                         self.ttl)
            if lease is not None:
                return lease
            if deadline is not None and clock() > deadline:
                raise TimeoutError(f"read lane {lane} not drained in {timeout}s")
            sleep(0.002)  # the drain barrier is armed; readers are leaving

    def keepalive(self, lease, worker: Optional[str] = None):
        """Renew mid-batch (call between prefill and decode, or per chunk).

        Rides the lock table's renewal fast path: one fencing-token-checked
        CAS on the expiry register, no shard ALock — and since the serving
        host is the table's local class, the keepalive costs **zero**
        simulated RDMA operations (``stats()['fast_renews']`` counts the
        fast-path hits; ``local_rdma_ops`` stays 0).
        """
        if worker is not None:
            renewed = self._worker(worker).renew(lease)
        else:
            # Anonymous keepalives ride the per-thread async pipeline:
            # home renewals resolve inline on the same zero-RDMA
            # fast path; remote ones ride the next flush as one
            # witness-CAS WR sharing a doorbell with queued work.
            pl = self._pipe()
            renewed = pl.sync(pl.renew(lease))
            self.svc.note_renewed(self._proc(), lease, renewed)
        if renewed is None:
            raise RuntimeError(
                f"admission lease on {lease.key} lost (token {lease.token}); "
                "the batch overran its TTL and the slot was re-granted"
            )
        return renewed

    def complete(self, lease, worker: Optional[str] = None) -> bool:
        if worker is not None:
            return self._worker(worker).release(lease)
        return self.svc.release(self._proc(), lease)

    def stats(self) -> Dict:
        totals = self.svc.class_totals()
        rows = self.svc.telemetry()
        return {
            "slots": self.num_slots,
            "read_slots": self.read_slots,
            "grants": sum(r["grants"] for r in rows),
            "rejects": sum(r["rejects"] for r in rows),
            "grants_shared": sum(r["grants_shared"] for r in rows),
            "grants_exclusive": sum(r["grants_exclusive"] for r in rows),
            "shared_joins": sum(r["shared_joins"] for r in rows),
            "shared_releases": sum(r["shared_releases"] for r in rows),
            "intent_blocks": sum(r["intent_blocks"] for r in rows),
            "expirations": sum(r["expirations"] for r in rows),
            "fast_renews": sum(r["fast_renews"] for r in rows),
            "fast_releases": sum(r["fast_releases"] for r in rows),
            "reclaims": sum(r["reclaims"] for r in rows),
            "reclaim_fast": sum(r["reclaim_fast"] for r in rows),
            "reclaim_rejects": sum(r["reclaim_rejects"] for r in rows),
            "orphan_probes": sum(r["orphan_probes"] for r in rows),
            "orphan_adopts": sum(r["orphan_adopts"] for r in rows),
            "workers": len(self._workers),
            "local_rdma_ops": totals[0].rdma_ops,
            "local_ops": totals[0].local_ops,
            # Overload-protection telemetry: admission-level sheds
            # plus the table-side shed/hedge/deadline counters; the
            # breaker/budget report appears only when a policy is armed.
            "sheds": self.sheds,
            "table_sheds": sum(r["sheds"] for r in rows),
            "hedges": sum(r["hedges"] for r in rows),
            "deadline_exceeded": sum(r["deadline_exceeded"] for r in rows),
            "overload": self.svc.overload_report(),
            # Pipeline telemetry, aggregated across server threads.
            "pipeline_flushes": sum(pl.stats["flushes"]
                                    for pl in self._pipes),
            "pipeline_flushed_ops": sum(pl.stats["flushed_ops"]
                                        for pl in self._pipes),
            "pipeline_hedge_rides": sum(pl.stats["hedge_rides"]
                                        for pl in self._pipes),
        }


def _finish(device: torch.device) -> None:
    """Wait until the device has run the work queued so far."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clock(device: torch.device) -> float:
    """Host time after the device has finished the work queued so far."""
    _finish(device)
    return time.perf_counter()


def serve(
    arch: str,
    *,
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen_len: int = 16,
    mesh_shape=(1, 1),
    mesh_axes=("data", "model"),
    greedy: bool = True,
    seed: int = 0,
    device=None,
    admission_slots: int = 0,
    admission_ttl: float = 30.0,
    admission: Optional[BatchAdmission] = None,
) -> Dict:
    """Serve one batch of random prompts with random weights drawn from ``seed``.
    A vision-frontend decoder's prompt of ``prompt_len`` positions is its
    ``frontend_tokens`` stub image embeddings, then the text tokens; an
    encoder (``causal`` False) has no decode path and is refused.

    On the mesh ``mesh_shape`` over ``mesh_axes`` (``launch.mesh.make_mesh``,
    every rank calling) each rank serves its ``(pod, data)`` rows, pod-major
    (``models.rank_inputs``), on its pod's blocks of the weights, and the
    tokens are gathered over those rows; with admission, rank 0 takes, renews
    and releases the lease while the others wait on it, so the lock table
    sees one grant a request.  A MoE model's groups span the ``(pod, data)``
    row ranks, as the reference's serving steps lay its batch
    (``models/moe.py``).

    Returns ``tokens`` ([batch, gen_len] int64 on the CPU), ``prefill_seconds``,
    ``decode_seconds_per_token`` and ``throughput_tok_s``; with admission, also
    ``admission``: :meth:`BatchAdmission.stats` with the slot's ``slot_key``
    and ``fence_token``.  A caller-supplied ``admission`` is the real gate,
    shared across calls and server threads; ``admission_slots`` alone builds a
    private table, useful for its telemetry but contended by no one else.
    """
    cfg = get_config(arch, smoke=smoke)
    if not cfg.causal:
        raise ValueError(f"{arch} is encoder-only: no decode path")
    mesh = make_mesh(mesh_shape, mesh_axes, device)
    dev, lead = mesh.device, not any(mesh.coords.values())
    if admission is None and admission_slots > 0 and lead:
        admission = BatchAdmission(num_slots=admission_slots, ttl=admission_ttl)
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(seed),
                  mesh=mesh)
    max_len = prompt_len + gen_len
    pshape = ShapeConfig("serve", prompt_len, batch, "prefill")
    prompts = rank_inputs(input_specs(cfg, pshape,
                                      generator=torch.Generator(dev).manual_seed(seed + 1),
                                      device=dev), cfg, pshape, mesh)
    sampler = torch.Generator(dev).manual_seed(seed + 2)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if greedy:
            return torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        probs = torch.softmax(logits[:, -1].float(), dim=-1)
        return torch.multinomial(probs, 1, generator=sampler)

    # Admit only now, and on the card only once prefill's kernels are built
    # and loaded: the slot TTL budgets batch execution, and an nvcc build
    # that outlasted it would expire a healthy batch's lease and let the slot
    # be granted twice.
    if dev.type == "cuda" and (admission or mesh.world_size > 1):
        ops.prepare(cfg.block_pattern)
    admission = admission if lead else None
    slot = admission.admit(timeout=admission_ttl) if admission else None
    if mesh.world_size > 1:
        dist.barrier(group=mesh.groups["world"])  # the other ranks wait on the lease
    try:
        t0 = _clock(dev)
        logits, caches = model.prefill(prompts, max_len)
        tok = pick(logits)
        prefill_s = _clock(dev) - t0
        if admission:
            slot = admission.keepalive(slot)  # prefill done; extend

        generated = [tok]
        t1 = _clock(dev)
        for step in range(gen_len - 1):
            logits, caches = model.decode_step(caches, tok)
            tok = pick(logits)
            generated.append(tok)
            if admission and step % 8 == 7:
                _finish(dev)  # vouch only for steps the device has run
                slot = admission.keepalive(slot)  # TTL covers ~8 steps
        decode_s = _clock(dev) - t1
    finally:
        # Release on *every* exit: an exception mid-batch must not hold the
        # slot hostage for the rest of its TTL.
        if admission:
            admission.complete(slot)

    tokens = gather_rows(torch.cat(generated, dim=1), mesh).cpu()
    out = {
        "tokens": tokens,
        "prefill_seconds": prefill_s,
        "decode_seconds_per_token": decode_s / max(gen_len - 1, 1),
        "throughput_tok_s": tokens.numel() / max(decode_s + prefill_s, 1e-9),
    }
    if admission:
        out["admission"] = dict(
            admission.stats(), slot_key=slot.key, fence_token=slot.token,
        )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true", help="published widths, not smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--admission-slots", type=int, default=0,
                    help="admit the batch through the sharded lock table")
    args = ap.parse_args()
    out = serve(args.arch, smoke=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen, device=args.device,
                admission_slots=args.admission_slots)
    print(f"[serve] generated {tuple(out['tokens'].shape)} tokens; "
          f"prefill {out['prefill_seconds']:.2f}s, "
          f"{out['decode_seconds_per_token'] * 1e3:.1f} ms/token, "
          f"{out['throughput_tok_s']:.1f} tok/s")
    print("[serve] first sequence:", out["tokens"][0][:16].tolist())
    if "admission" in out:
        print("[serve] admission:", out["admission"])


if __name__ == "__main__":
    main()
