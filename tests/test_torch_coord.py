"""The port's copy of the control plane (``repro_torch.core``/``coord``)
against the JAX package's: the same seeded script of lease operations on both
gives the same leases, telemetry and operation counts, and each copied module
is its original under the port's rewrites and nothing else."""

import dataclasses
import enum
import importlib
import inspect
import random
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

# The modules copied into the port, by path under each package.
COPIED = [
    "core/memory.py", "core/mcs.py", "core/peterson.py", "core/alock.py",
    "coord/__init__.py", "coord/faults.py", "coord/inflation.py",
    "coord/overload.py", "coord/table.py", "coord/ledger.py",
    "coord/membership.py", "coord/pipeline.py", "coord/service.py",
]

# What the port changes in a copy, in order: absolute imports of the core
# become relative, the package is renamed in docstrings and comments, and
# the reference's citations of its own change history are dropped.
REWRITES = [
    (re.compile(r"^from repro\.core import", re.M), "from ..core import"),
    (re.compile(r"\brepro\."), "repro_torch."),
    (re.compile(r"\n(\s*# )\(PR \d+\): "), r":\n\1"),
    (re.compile(r" \(PR \d+\)"), ""),
    (re.compile(r"PR \d+ taught single table transactions to post"),
     "Single table transactions post"),
    (re.compile(r'(^|"""|# )PR \d+ (\w)', re.M), lambda m: m[1] + m[2].upper()),
    (re.compile(r"\bPR \d+ "), ""),
]


def rewrite(text: str) -> str:
    for pattern, repl in REWRITES:
        text = pattern.sub(repl, text)
    return text


def _first_difference(a: str, b: str) -> str:
    for n, (x, y) in enumerate(zip(a.splitlines(), b.splitlines()), 1):
        if x != y:
            return f"line {n}:\n  rewritten reference: {x!r}\n  port:                {y!r}"
    return f"lengths differ: {len(a.splitlines())} vs {len(b.splitlines())} lines"


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_differs_only_by_the_port_rewrites(path):
    ref = (SRC / "repro" / path).read_text()
    port = (SRC / "repro_torch" / path).read_text()
    expect = rewrite(ref)
    assert port == expect, _first_difference(expect, port)


def test_batch_admission_differs_only_by_the_port_rewrites():
    from repro.launch.serve import BatchAdmission as JaxAdmission
    from repro_torch.launch.serve import BatchAdmission

    expect = rewrite(inspect.getsource(JaxAdmission))
    port = inspect.getsource(BatchAdmission)
    assert port == expect, _first_difference(expect, port)


def test_port_core_exports_the_control_plane():
    import repro.core as jcore
    import repro_torch.core as tcore

    names = ["NULLPTR", "TIMEOUT", "AsymmetricMemory", "DeadlineExceeded", "OpCounts",
             "OperationNotEnabled", "Overloaded", "Process", "Register", "RemoteTimeout",
             "make_scheduler", "BudgetedMCSLock", "InflatedKeyQueue",
             "ModifiedPetersonLock", "ALock", "BrokenMixedCASLock", "FilterLock",
             "NaiveRCASLock", "RPCLock"]
    # The data plane: the reference's cohort collectives and cost model,
    # with the H100 in place of the TPU.
    data_plane = ["SyncConfig", "cohort_all_reduce", "flat_all_reduce", "pod_average_params",
                  "pod_sync_grads", "all_gather_wire_bytes", "all_to_all_wire_bytes",
                  "allreduce_wire_bytes", "cohort_vs_flat_dcn_bytes",
                  "reduce_scatter_wire_bytes"]
    for name in names + data_plane:
        assert hasattr(jcore, name) and hasattr(tcore, name), name
        obj = getattr(tcore, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch.core."), (name, obj.__module__)
    assert hasattr(tcore, "H100") and not hasattr(tcore, "TPUv5e")
    assert not hasattr(tcore, "wrap_step_with_pod_sync") and not hasattr(tcore, "modelcheck")


def test_port_coord_exports_what_the_reference_exports():
    import repro.coord as jcoord
    import repro_torch.coord as tcoord

    public = {n for n in dir(jcoord) if not n.startswith("_")}
    assert public == {n for n in dir(tcoord) if not n.startswith("_")}


# ------------------------------------------------------- scripted parity --
TTL = 5.0


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def plain(x):
    """``x`` with every dataclass, enum and container of either package turned
    into builtins, so that results from the two packages compare equal."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


OPS = ["acq_x", "acq_s", "renew", "release", "advance", "async_renew", "rc_acquire",
       "rc_renew", "restart", "elect"]
WEIGHTS = [6, 4, 4, 4, 3, 3, 2, 2, 1, 2]


def run_script(pkg: str, num_hosts: int, num_shards: int, seed: int, steps: int = 400):
    """Drive one service of ``pkg`` with the script that ``seed`` draws and
    return the log of every call and its result, then the service's
    telemetry and per-class operation totals."""
    coord = importlib.import_module(f"{pkg}.coord")
    clock = FakeClock()
    svc = coord.CoordinationService(num_hosts=num_hosts, num_shards=num_shards,
                                    seed=seed, clock=clock, sleep=clock.advance)
    shared = coord.LeaseMode.SHARED
    rng = random.Random(seed)
    procs = [svc.host_process(i % num_hosts) for i in range(2 * num_hosts)]
    keys = [f"key{i}" for i in range(2 * num_shards)]
    homes = {"ckpt": 0, "leader": num_hosts - 1}
    held, pipes, clients, log = [], {}, {}, []

    for _ in range(steps):
        op = rng.choices(OPS, WEIGHTS)[0]
        if op in ("acq_x", "acq_s"):
            i, key = rng.randrange(len(procs)), rng.choice(keys)
            kw = {"mode": shared} if op == "acq_s" else {}
            lease = svc.try_acquire(procs[i], key, TTL, **kw)
            log.append((op, i, key, plain(lease)))
            if lease is not None:
                held.append((i, lease))
        elif op in ("renew", "async_renew") and held:
            j = rng.randrange(len(held))
            i, lease = held[j]
            if op == "renew":
                got = svc.renew(procs[i], lease)
            else:
                pipe = pipes.get(i) or pipes.setdefault(i, svc.async_client(procs[i]))
                got = pipe.sync(pipe.renew(lease))
                svc.note_renewed(procs[i], lease, got)
            log.append((op, i, plain(lease), plain(got)))
            if got is None:
                held.pop(j)
            else:
                held[j] = (i, got)
        elif op == "release" and held:
            i, lease = held.pop(rng.randrange(len(held)))
            log.append((op, i, plain(lease), svc.release(procs[i], lease)))
        elif op == "advance":
            dt = rng.choice([0.25, 1.0, 1.5 * TTL])
            clock.advance(dt)
            log.append((op, dt))
        elif op == "rc_acquire":
            name = rng.choice(["w0", "w1"])
            if name not in clients:
                i = rng.randrange(len(procs))
                clients[name] = (i, svc.recoverable(name, procs[i]), [])
            i, rc, leases = clients[name]
            key = rng.choice(keys)
            lease = rc.try_acquire(key, TTL)
            log.append((op, name, key, plain(lease)))
            if lease is not None:
                leases.append(lease)
        elif op == "rc_renew" and clients:
            name = rng.choice(sorted(clients))
            i, rc, leases = clients[name]
            if leases:
                j = rng.randrange(len(leases))
                got = rc.renew(leases[j])
                log.append((op, name, plain(leases[j]), plain(got)))
                if got is None:
                    leases.pop(j)
                else:
                    leases[j] = got
        elif op == "restart" and clients:
            name = rng.choice(sorted(clients))
            host = rng.randrange(num_hosts)
            procs.append(svc.host_process(host))
            client, reclaimed = svc.restart(name, procs[-1])
            clients[name] = (len(procs) - 1, client, list(reclaimed))
            log.append((op, name, host, plain(reclaimed)))
        elif op == "elect":
            name, i = rng.choice(sorted(homes)), rng.randrange(len(procs))
            epoch = rng.randrange(6)
            log.append((op, name, i, epoch, svc.elect(name, procs[i], epoch, homes[name])))

    log.append(("telemetry", plain(svc.telemetry())))
    log.append(("class_totals", plain(svc.class_totals())))
    return log, svc


@pytest.mark.parametrize("num_hosts,num_shards", [(1, 4), (4, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_parity_with_the_reference(seed, num_hosts, num_shards):
    ref_log, _ = run_script("repro", num_hosts, num_shards, seed)
    port_log, svc = run_script("repro_torch", num_hosts, num_shards, seed)
    for n, (a, b) in enumerate(zip(ref_log, port_log)):
        assert a == b, f"step {n}: reference {a!r}\nport {b!r}"
    assert len(ref_log) == len(port_log)

    # The script reached what it is meant to compare.
    done = {entry[0] for entry in port_log}
    assert {"acq_x", "acq_s", "renew", "release", "async_renew", "rc_acquire",
            "restart", "elect"} <= done
    rows = svc.telemetry()
    assert sum(r["grants_exclusive"] for r in rows) > 0
    assert sum(r["grants_shared"] for r in rows) > 0
    assert sum(r["expirations"] for r in rows) > 0
    totals = svc.class_totals()
    assert sum(r["reclaims"] for r in rows) > 0
    assert totals[0].rdma_ops == 0  # the local class (class 0) never touches the fabric
    if num_hosts > 1:
        assert sum(c.rdma_ops for c in totals.values()) > 0
