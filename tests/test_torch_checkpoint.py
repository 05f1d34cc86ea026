"""The port's checkpoints: the reference's own cases
(``tests/test_checkpoint.py``) against the port, then the file format both
ways (a JAX train state restores into the port and the other way round,
bit-exact in bf16), the async copy, and resume against an uninterrupted run."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import init_train_state as jax_init_train_state  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.coord import CoordinationService  # noqa: E402
from repro_torch.launch.steps import init_train_state, restore_train_state  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 8), generator=g), "b": torch.zeros((8,))},
        "opt": {"step": torch.tensor(7, dtype=torch.int32), "mu": {"w": torch.ones((4, 8))}},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 7, s, extra={"arch": "x"})
    restored, step, extra = load_checkpoint(str(tmp_path), s)
    assert step == 7 and extra == {"arch": "x"}
    for a, b in zip(_leaves(s), _leaves(restored), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_corrupted_latest_falls_back(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    save_checkpoint(str(tmp_path), 2, s)
    (tmp_path / "step_00000002.npz").write_bytes(b"garbage" * 100)
    _, step, _ = load_checkpoint(str(tmp_path), s)
    assert step == 1


def test_checksum_mismatch_detected(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 3, s)
    mpath = tmp_path / "step_00000003.json"
    m = json.loads(mpath.read_text())
    first = next(iter(m["arrays"]))
    m["arrays"][first]["crc"] += 1
    mpath.write_text(json.dumps(m))
    with pytest.raises(IOError, match="checksum mismatch"):
        load_checkpoint(str(tmp_path), s)


def test_shape_mismatch_rejected(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    bad = _state()
    bad["params"]["w"] = torch.zeros((5, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), bad)


def test_missing_array_and_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), _state())
    save_checkpoint(str(tmp_path), 1, _state())
    more = _state()
    more["opt"]["nu"] = {"w": torch.ones((4, 8))}
    with pytest.raises(KeyError, match="opt/nu/w"):
        load_checkpoint(str(tmp_path), more)


def test_manager_elects_single_writer_and_gcs(tmp_path):
    svc = CoordinationService(num_hosts=3)
    mgrs = [CheckpointManager(str(tmp_path), every=1, keep=2, svc=svc, host=h)
            for h in range(3)]
    s = _state()
    for step in (1, 2, 3, 4):
        wrote = [m.maybe_save(step, s) for m in mgrs]
        assert sum(wrote) == 1, f"step {step}: {wrote}"
    for m in mgrs:
        m.wait()
    steps = sorted(int(f[len("step_"):-len(".json")])
                   for f in os.listdir(tmp_path) if f.endswith(".json"))
    assert steps == [3, 4]  # keep=2 retention


def test_async_save_holds_the_values_of_its_step(tmp_path):
    """The state is copied before maybe_save returns: an in-place update
    right after it does not reach the file."""
    s = _state()
    mgr = CheckpointManager(str(tmp_path), every=1, keep=0)
    assert mgr.maybe_save(1, s)
    before = s["params"]["w"].clone()
    s["params"]["w"].add_(1.0)
    mgr.wait()
    restored, _, _ = load_checkpoint(str(tmp_path), s)
    assert torch.equal(restored["params"]["w"], before)


def _jax_state(dtype):
    cfg = jax_config("recurrentgemma-9b", smoke=True).with_overrides(dtype=dtype)
    jrun = JaxRunConfig(optimizer_state_dtype=dtype)
    state = jax_init_train_state(JaxModel(cfg), jrun, jax.random.PRNGKey(0))
    # Moments that are not zero, so that a mix-up between them shows.
    opt = state["opt"]
    opt["mu"] = jax.tree.map(lambda m, p: (p * 0.5).astype(m.dtype), opt["mu"], state["params"])
    opt["nu"] = jax.tree.map(lambda m, p: (p * p).astype(m.dtype), opt["nu"], state["params"])
    opt["step"] = jnp.int32(3)
    return jax.device_get(state)


def _port_state(dtype):
    model = Model(get_config("recurrentgemma-9b", smoke=True).with_overrides(dtype=dtype),
                  device="cpu")
    return init_train_state(model, RunConfig(optimizer_state_dtype=dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_checkpoint_restores_into_the_port_bit_exact(tmp_path, dtype):
    jstate = _jax_state(dtype)
    jax_save_checkpoint(str(tmp_path), 3, jstate, extra={"arch": "recurrentgemma-9b"})
    state = _port_state(dtype)
    restored, step, extra = load_checkpoint(str(tmp_path), state)
    restore_train_state(state, restored)
    assert step == 3 and extra == {"arch": "recurrentgemma-9b"}
    want = train_state_from_jax(jstate)
    assert int(state["opt"]["step"]) == 3 and state["opt"]["step"].dtype == torch.int32
    for group in ("params", "mu", "nu"):
        got = state["params"] if group == "params" else state["opt"][group]
        exp = want["params"] if group == "params" else want["opt"][group]
        assert set(got) == set(exp)
        for key, t in got.items():
            assert t.dtype == exp[key].dtype, key
            assert torch.equal(t.detach(), exp[key]), (group, key)
    assert state["params"]["blocks.b0.rec.lam"].dtype == torch.float32
    assert state["opt"]["mu"]["blocks.b0.rec.lam"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_into_jax_bit_exact(tmp_path, dtype):
    jstate = _jax_state(dtype)
    state = _port_state(dtype)
    restore_train_state(state, train_state_from_jax(jstate))
    save_checkpoint(str(tmp_path), 3, state)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
    restored, step, _ = jax_load_checkpoint(str(tmp_path), like)
    assert step == 3
    flat_got = jax.tree_util.tree_flatten_with_path(restored)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8), err_msg=str(path))


def test_manifests_name_the_same_arrays(tmp_path):
    """Same keys, shapes, dtype tags and crcs for the same state."""
    jstate = _jax_state("bfloat16")
    jax_save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    state = _port_state("bfloat16")
    restore_train_state(state, train_state_from_jax(jstate))
    save_checkpoint(str(tmp_path / "port"), 1, state)
    read = lambda d: json.loads((tmp_path / d / "step_00000001.json").read_text())["arrays"]
    got, want = read("port"), read("jax")
    assert got == want
    assert {"params/blocks/b0/rec/w_a", "params/tail/1/ffn/wo", "opt/step",
            "opt/mu/embed/table"} <= set(got)
    assert got["params/embed/table"]["dtype"] == "bfloat16"


def test_resume_matches_uninterrupted_run(tmp_path):
    """Checkpoint at step 3, resume, steps 4-6: the losses and the final
    state equal those of one run through step 6."""
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=6, checkpoint_every=3)
    whole = train("llama3.2-1b", steps=6, shape=shape, log_every=1, device="cpu",
                  run=RunConfig(checkpoint_dir=str(tmp_path / "a"), **kw))
    run = RunConfig(checkpoint_dir=str(tmp_path / "b"), **kw)
    first = train("llama3.2-1b", steps=3, shape=shape, log_every=1, device="cpu", run=run)
    rest = train("llama3.2-1b", steps=6, shape=shape, log_every=1, device="cpu", run=run,
                 resume=True)
    losses = [h["loss"] for h in first["history"] + rest["history"]]
    assert [h["step"] for h in rest["history"]] == [4, 5, 6]
    assert losses == [h["loss"] for h in whole["history"]]
    a, b = whole["final_state"], rest["final_state"]
    for key, t in a["params"].items():
        assert torch.equal(t, b["params"][key]), key
        assert torch.equal(a["opt"]["mu"][key], b["opt"]["mu"][key]), key
    assert int(b["opt"]["step"]) == 6


def test_unknown_dtype_tag_is_refused(tmp_path):
    """A tag this port cannot decode (the reference also writes fp8 as
    tagged bits) raises rather than restoring raw bits."""
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    mpath = tmp_path / "step_00000001.json"
    m = json.loads(mpath.read_text())
    m["arrays"]["params/w"]["dtype"] = "float8_e4m3fn"
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        load_checkpoint(str(tmp_path), s)


def test_retention_counts_a_write_that_lands_at_once(tmp_path, monkeypatch):
    """A write that is on disk before maybe_save returns (here: written
    synchronously) still leaves ``keep`` checkpoints, not fewer."""
    from repro_torch.checkpoint import ckpt

    real = ckpt.save_checkpoint
    monkeypatch.setattr(ckpt, "save_checkpoint",
                        lambda *a, _async=False, **k: real(*a, **k))
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    for step in (1, 2, 3, 4):
        assert mgr.maybe_save(step, _state())
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".json")) == [
        "step_00000003.json", "step_00000004.json"]
