"""Batch admission through the lock table, in the port and in the reference.

The JAX package's admission tests run here against both packages through the
``pkg`` fixture; then the port's ``serve(..., admission_slots=N)``: its tokens
equal the bare path's, its admission counters equal the reference serve's,
its keepalives follow finished decode steps, a batch that fails mid-decode
frees its slot, and concurrent server threads never hold more leases than
there are slots."""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.serve import BatchAdmission, serve  # noqa: E402


@pytest.fixture(params=["repro", "repro_torch"])
def pkg(request):
    name = request.param
    coord = importlib.import_module(f"{name}.coord")
    return SimpleNamespace(
        BatchAdmission=importlib.import_module(f"{name}.launch.serve").BatchAdmission,
        CoordinationService=coord.CoordinationService,
        LeaseMode=coord.LeaseMode,
        OverloadPolicy=coord.OverloadPolicy,
        Overloaded=importlib.import_module(f"{name}.core").Overloaded,
    )


# ------------------------------- the reference's admission tests, both packages
def test_admission_read_lanes_stack_readers_and_quiesce_drains(pkg):
    adm = pkg.BatchAdmission(num_slots=2, ttl=30.0, read_slots=2)
    # Write slots are exclusive: 2 slots, third admit times out.
    w1, w2 = adm.admit(timeout=0.05), adm.admit(timeout=0.05)
    with pytest.raises(TimeoutError):
        adm.admit(timeout=0.05)
    # Read lanes are shared: many concurrent readers, no capacity consumed.
    readers = [adm.admit_read(timeout=0.05) for _ in range(6)]
    assert all(r.mode == pkg.LeaseMode.SHARED for r in readers)
    st = adm.stats()
    assert st["grants_shared"] == 6 and st["grants_exclusive"] == 2
    assert st["local_rdma_ops"] == 0  # the serving host is the local class
    for r in readers[:5]:
        assert adm.complete(r)
    # Quiesce the last reader's lane from its own maintenance thread (each
    # server thread is its own coordination Process): the drain barrier holds
    # it out until the reader completes on ITS thread.
    lane_idx = int(readers[5].key.rsplit("readlane", 1)[1])
    out = {}

    def maintenance():
        out["lease"] = adm.quiesce(lane=lane_idx, timeout=10.0)

    t = threading.Thread(target=maintenance)
    t.start()
    time.sleep(0.05)  # let the quiesce block on the live reader
    assert "lease" not in out
    assert adm.complete(readers[5])  # reader leaves on the admitting thread
    t.join(timeout=10.0)
    maint = out["lease"]
    assert maint.mode == pkg.LeaseMode.EXCLUSIVE
    # Exclusive releases are witness CASes: any thread may complete them.
    assert adm.complete(maint)
    assert adm.complete(w1) and adm.complete(w2)


def test_admission_rejects_bad_read_slot_configs(pkg):
    adm = pkg.BatchAdmission(num_slots=1)
    with pytest.raises(ValueError):
        adm.admit_read()
    with pytest.raises(ValueError):
        adm.quiesce(lane=0)
    with pytest.raises(ValueError):
        pkg.BatchAdmission(num_slots=1, read_slots=-1)


def _brownout_admission(pkg):
    svc = pkg.CoordinationService(num_hosts=1, num_shards=4,
                                  overload=pkg.OverloadPolicy())
    return pkg.BatchAdmission(num_slots=2, ttl=30.0, svc=svc,
                              read_slots=2), svc.table.overload


def test_open_breaker_sheds_exclusive_but_reads_flow(pkg):
    adm, ctl = _brownout_admission(pkg)
    for _ in range(8):
        ctl.breaker(0).record(False, 0.0)
    assert ctl.breaker_open(0)
    with pytest.raises(pkg.Overloaded) as exc:
        adm.admit(timeout=0.0)
    assert exc.value.reason == "breaker"
    assert adm.stats()["sheds"] == 1
    # Brownout: the read lane is ungated, so shared-mode reads keep flowing
    # while exclusive admissions shed.
    lease = adm.admit_read()
    assert lease is not None and lease.mode == pkg.LeaseMode.SHARED
    assert adm.complete(lease)


def test_dry_budget_sheds_at_admission(pkg):
    adm, ctl = _brownout_admission(pkg)
    ctl.budget(0).tokens = 0.0
    with pytest.raises(pkg.Overloaded) as exc:
        adm.admit(timeout=0.0)
    assert exc.value.reason == "budget"
    assert adm.stats()["sheds"] == 1


def test_ungated_without_policy(pkg):
    adm = pkg.BatchAdmission(num_slots=2, ttl=30.0, read_slots=1)
    lease = adm.admit(timeout=0.0)
    assert lease is not None
    assert adm.complete(lease)
    assert adm.stats()["sheds"] == 0


def test_batch_admission_worker_recovery(pkg):
    adm = pkg.BatchAdmission(num_slots=2, ttl=60.0)
    box = {}

    def worker():
        box["lease"] = adm.admit(worker="w0")

    t = threading.Thread(target=worker)
    t.start()
    t.join()

    def replacement():
        box["reclaimed"] = adm.recover("w0")

    t2 = threading.Thread(target=replacement)
    t2.start()
    t2.join()
    lease, reclaimed = box["lease"], box["reclaimed"]
    assert [r.key for r in reclaimed] == [lease.key]
    assert reclaimed[0].token == lease.token  # resumed, not re-queued
    assert adm.complete(reclaimed[0], worker="w0")
    s = adm.stats()
    assert s["reclaims"] == 1 and s["local_rdma_ops"] == 0


# --------------------------------------------------- the port's admitted serve
# Decode steps 7 and 15 keep alive, after the one that follows prefill.
SERVE_KW = dict(batch=2, prompt_len=8, gen_len=18)
ADMISSION_KEYS = ("grants", "fast_renews", "expirations", "local_rdma_ops",
                  "slot_key", "fence_token")


def test_admitted_serve_matches_bare_tokens_and_reference_counters():
    from repro.launch.serve import serve as jax_serve

    bare = serve("llama3.2-1b", device="cpu", seed=3, **SERVE_KW)
    out = serve("llama3.2-1b", device="cpu", seed=3, admission_slots=2, **SERVE_KW)
    assert "admission" not in bare
    assert torch.equal(out["tokens"], bare["tokens"])
    expect = jax_serve("llama3.2-1b", seed=3, admission_slots=2, **SERVE_KW)["admission"]
    adm = out["admission"]
    assert set(adm) == set(expect)
    assert {k: adm[k] for k in ADMISSION_KEYS} == {k: expect[k] for k in ADMISSION_KEYS}
    assert adm["grants"] == 1 and adm["fast_renews"] == 3 and adm["expirations"] == 0
    assert adm["local_rdma_ops"] == 0 and adm["slot_key"] == "serve/slot0"


def test_keepalives_follow_finished_decode_steps(monkeypatch):
    """Each keepalive comes after a wait for the device (``_finish``) that
    follows the last decode step it vouches for: one after prefill, then one
    per 8 decode steps."""
    events = []
    real_finish, real_step = serve_mod._finish, serve_mod.Model.decode_step

    def finish(dev):
        events.append("finish")
        real_finish(dev)

    def step(self, caches, tok):
        events.append("step")
        return real_step(self, caches, tok)

    class Recording(BatchAdmission):
        def admit(self, *a, **kw):
            events.append("admit")
            return super().admit(*a, **kw)

        def keepalive(self, lease, worker=None):
            events.append("keepalive")
            return super().keepalive(lease, worker)

        def complete(self, lease, worker=None):
            events.append("complete")
            return super().complete(lease, worker)

    monkeypatch.setattr(serve_mod, "_finish", finish)
    monkeypatch.setattr(serve_mod.Model, "decode_step", step)
    out = serve("llama3.2-1b", device="cpu", admission=Recording(num_slots=1), **SERVE_KW)
    assert events[0] == "admit" and events[-1] == "complete"
    steps_before = [events[:i].count("step") for i, e in enumerate(events) if e == "keepalive"]
    assert steps_before == [0, 8, 16]
    for i, e in enumerate(events):
        if e == "keepalive":
            assert events[i - 1] == "finish", events[:i + 1]
    assert out["admission"]["fast_renews"] == 3


def test_bare_serve_never_waits_mid_decode(monkeypatch):
    """Without admission the decode loop queues its steps and waits only for
    the clock at its ends, as before admission existed."""
    calls = []
    monkeypatch.setattr(serve_mod, "_finish", lambda dev: calls.append(dev))
    serve("llama3.2-1b", device="cpu", **SERVE_KW)
    assert len(calls) == 4  # the clock around prefill and around decode


def test_decode_failure_mid_batch_frees_the_slot(monkeypatch):
    real_step = serve_mod.Model.decode_step
    calls = []

    def failing(self, caches, tok):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("decode failed")
        return real_step(self, caches, tok)

    adm = BatchAdmission(num_slots=1, ttl=30.0)
    monkeypatch.setattr(serve_mod.Model, "decode_step", failing)
    with pytest.raises(RuntimeError, match="decode failed"):
        serve("llama3.2-1b", device="cpu", admission=adm, **SERVE_KW)
    st = adm.stats()
    assert st["grants"] == 1 and st["fast_releases"] == 1 and st["expirations"] == 0
    lease = adm.admit(timeout=0)  # the one slot is free at once
    assert lease.key == "serve/slot0" and lease.token > 1
    assert adm.complete(lease)


def test_threads_never_exceed_the_slots():
    """Four server threads share two slots: at most two batches are ever
    inside their leases, each gets the single-thread tokens, and every
    admission carries its own (slot, fence token)."""
    guard, inside, peak = threading.Lock(), [0], [0]

    class Counting(BatchAdmission):
        def admit(self, *a, **kw):
            lease = super().admit(*a, **kw)
            with guard:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            time.sleep(0.02)  # hold the slot long enough for the others to queue
            return lease

        def complete(self, lease, worker=None):
            with guard:
                inside[0] -= 1
            return super().complete(lease, worker)

    kw = dict(device="cpu", batch=1, prompt_len=8, gen_len=10)
    expect = serve("llama3.2-1b", **kw)["tokens"]
    adm = Counting(num_slots=2, ttl=60.0)
    results, errors = [None] * 4, []

    def server(i):
        try:
            results[i] = serve("llama3.2-1b", admission=adm, **kw)
        except BaseException as exc:  # surfaced below, with the thread's index
            errors.append((i, exc))

    threads = [threading.Thread(target=server, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert 1 <= peak[0] <= 2 and inside[0] == 0
    for res in results:
        assert torch.equal(res["tokens"], expect)
    fences = {(r["admission"]["slot_key"], r["admission"]["fence_token"]) for r in results}
    assert len(fences) == 4
    assert adm.stats()["grants"] == 4 and adm.stats()["local_rdma_ops"] == 0


def test_prepare_builds_each_kernel_once_in_one_parallel_build(monkeypatch):
    builds, loads = [], []
    monkeypatch.setattr(build, "build", lambda names: builds.append(list(names)))
    monkeypatch.setattr(build, "load", loads.append)
    assert ops.prepare(("rec", "rec", "attn")) == ["flash_attention",
                                                                 "rglru_scan"]
    assert ops.prepare(("attn",)) == ["flash_attention"]
    assert builds == [["flash_attention", "rglru_scan"], ["flash_attention"]]
    assert loads == ["flash_attention", "rglru_scan", "flash_attention"]


def test_admitted_xlstm_serve_matches_bare_and_prepares_no_kernel(monkeypatch):
    """The xLSTM kinds launch no kernel of the port: ``prepare`` builds and
    loads nothing for them (an unknown kind still raises), and an admitted
    xlstm serve gives the bare serve's tokens with the usual lease counters."""
    builds, loads = [], []
    monkeypatch.setattr(build, "build", lambda names: builds.append(list(names)))
    monkeypatch.setattr(build, "load", loads.append)
    assert ops.prepare(("mlstm", "slstm")) == []
    assert ops.prepare(("mlstm",) * 7 + ("slstm",)) == []
    assert ops.prepare(("rec", "mlstm", "attn", "slstm")) == ["flash_attention", "rglru_scan"]
    with pytest.raises(KeyError):
        ops.prepare(("mlstm", "conv"))
    assert builds == [[], [], ["flash_attention", "rglru_scan"]]
    assert loads == ["flash_attention", "rglru_scan"]

    bare = serve("xlstm-1.3b", device="cpu", seed=3, **SERVE_KW)
    out = serve("xlstm-1.3b", device="cpu", seed=3, admission_slots=2, **SERVE_KW)
    assert torch.equal(out["tokens"], bare["tokens"])
    adm = out["admission"]
    assert adm["grants"] == 1 and adm["fast_renews"] == 3 and adm["expirations"] == 0
    assert adm["local_rdma_ops"] == 0 and adm["slot_key"] == "serve/slot0"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_admitted_serve_on_card_loads_kernels_before_admitting(cuda, monkeypatch):
    """On the card the kernels are loaded when the slot is taken, and the
    stream has no unfinished work at any keepalive."""
    seen = []

    class Checking(BatchAdmission):
        def admit(self, *a, **kw):
            seen.append(("admit", set(build._loaded)))
            return super().admit(*a, **kw)

        def keepalive(self, lease, worker=None):
            seen.append(("keepalive", torch.cuda.current_stream().query()))
            return super().keepalive(lease, worker)

    monkeypatch.setattr(build, "_loaded", {})
    bare = serve("llama3.2-1b", device="cuda", **SERVE_KW)
    monkeypatch.setattr(build, "_loaded", {})
    out = serve("llama3.2-1b", device="cuda", admission=Checking(num_slots=1), **SERVE_KW)
    assert seen[0] == ("admit", {"flash_attention"})
    assert [s for s in seen[1:]] == [("keepalive", True)] * 3
    assert torch.equal(out["tokens"], bare["tokens"])
