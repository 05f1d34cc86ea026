"""The slice as a whole: recurrentgemma-9b training through ``train()`` at
``chip_smoke.py`` phase 6(d)'s layout (8 layers: two ``(rec, rec, attn)``
super-blocks under remat and two tail ``rec`` layers) and smoke widths, on
the CPU, where the scan's backward is its plain reverse loop.

The port's loss curve against the JAX package's ``train()`` from one initial
state, and the calls of each plain version per training step against the
counts that phase 6(d) expects of the kernels on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import train as jax_train_mod  # noqa: E402
from repro.launch.steps import init_train_state as jax_init_train_state  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import layer_plan  # noqa: E402

ARCH, LAYERS = "recurrentgemma-9b", 8
# fp32 on both sides: summation order only, compounded over the updates (as
# test_torch_trainer.py's fp32 curve).
LOSS_RTOL, DLOSS_ATOL, GNORM_RTOL = 1e-4, 1e-5, 1e-5


def _eight_layers(config):
    return lambda arch, smoke: config(arch, smoke).with_overrides(num_layers=LAYERS,
                                                                  dtype="float32")


def test_eight_layer_train_curve_matches_jax_train(tmp_path, monkeypatch):
    """Four steps of two microbatches, the window (16) shorter than the rows
    (32); the port resumes a step-0 checkpoint the JAX package wrote."""
    steps = 4
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=steps,
              checkpoint_every=10 ** 9, microbatches=2)
    monkeypatch.setattr(jax_train_mod, "get_config", _eight_layers(jax_config))
    monkeypatch.setattr(train_mod, "get_config", _eight_layers(get_config))
    jrun = JaxRunConfig(checkpoint_dir=str(tmp_path / "jax"), **kw)
    run = RunConfig(checkpoint_dir=str(tmp_path / "port"), **kw)
    jcfg = jax_train_mod.get_config(ARCH, True)
    assert jcfg.num_layers == LAYERS and 0 < jcfg.window < 32
    init = jax_init_train_state(JaxModel(jcfg), jrun, jax.random.PRNGKey(jrun.seed))
    jax_save_checkpoint(run.checkpoint_dir, 0, jax.device_get(init))

    expect = jax_train_mod.train(ARCH, steps=steps, run=jrun, log_every=1,
                                 shape=JaxShapeConfig("t", 32, 4, "train"))
    out = train_mod.train(ARCH, steps=steps, run=run, log_every=1, resume=True,
                          shape=ShapeConfig("t", 32, 4, "train"), device="cpu")
    losses = np.array([h["loss"] for h in out["history"]])
    want = np.array([h["loss"] for h in expect["history"]])
    gnorms = np.array([h["grad_norm"] for h in out["history"]])
    want_gnorms = np.array([h["grad_norm"] for h in expect["history"]])
    assert [h["step"] for h in out["history"]] == list(range(1, steps + 1))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses - losses[0], want - want[0], rtol=0, atol=DLOSS_ATOL)
    np.testing.assert_allclose(gnorms, want_gnorms, rtol=GNORM_RTOL)


def test_eight_layer_step_calls_each_plain_version_as_phase_6d_counts(tmp_path, monkeypatch):
    """One step of four one-row microbatches: per microbatch, every layer's
    forward once and the super-blocks' once more in remat's recompute, and
    every layer's backward once: 40 scan forwards, 24 scan backwards, 16
    attention forwards (with lse) and 8 attention backwards; the scan's
    forward is never called by a backward."""
    monkeypatch.setattr(train_mod, "get_config", _eight_layers(get_config))
    plan = layer_plan(train_mod.get_config(ARCH, True))
    assert (plan.pattern, plan.n_scan, plan.tail) == (("rec", "rec", "attn"), 2, ("rec", "rec"))
    calls = {}
    for name in ("rglru_scan_ref", "rglru_scan_bwd_ref", "flash_attention_lse_ref",
                 "flash_attention_ref", "flash_attention_bwd_ref"):
        real = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=real, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=1, microbatches=4,
                    checkpoint_every=10 ** 9, checkpoint_dir=str(tmp_path))
    out = train_mod.train(ARCH, steps=1, run=run, log_every=1, device="cpu",
                          shape=ShapeConfig("t", 32, 4, "train"))
    assert np.isfinite(out["history"][0]["loss"])
    assert calls == {"rglru_scan_ref": 40, "rglru_scan_bwd_ref": 24,
                     "flash_attention_lse_ref": 16, "flash_attention_bwd_ref": 8}
