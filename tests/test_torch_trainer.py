"""The port's trainer against the JAX package's: the 10-step ``train()``
loss curve against the reference's ``train()`` from one initial state (fp32
and bf16), and the quickstart example on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.launch import train as train_mod  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


# fp32: summation order only, compounded over ten updates.  bf16: the two
# frameworks round at different places; this test's run (``pytest -s``
# prints the gaps) reads the losses at most 8.4e-5 apart relative, the loss
# changes loss_i - loss_0 4.6e-4 absolute (they are 3e-3 to 3e-2, so each
# step's update shows) and the grad-norms 2.2e-3 relative.
@pytest.mark.parametrize("dtype,loss_rtol,dloss_atol,gnorm_rtol", [
    ("float32", 1e-4, 1e-5, 1e-5),
    ("bfloat16", 2e-2, 1e-3, 5e-3),
])
def test_ten_step_train_curve_matches_jax_train(tmp_path, monkeypatch, dtype, loss_rtol,
                                                dloss_atol, gnorm_rtol):
    """Both trainers from one JAX ``init_train_state``: the port resumes it
    from a checkpoint the JAX package wrote at step 0.  The batches differ
    from step to step, so each loss change holds both the batch and every
    update before it; it is compared, not the sign of the last one."""
    arch, steps = "llama3.2-1b", 10
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=steps,
              checkpoint_every=10 ** 9, microbatches=2)
    monkeypatch.setattr(jax_train_mod, "get_config",
                        lambda a, smoke: jax_config(a, smoke).with_overrides(dtype=dtype))
    monkeypatch.setattr(train_mod, "get_config",
                        lambda a, smoke: get_config(a, smoke).with_overrides(dtype=dtype))
    jrun = JaxRunConfig(checkpoint_dir=str(tmp_path / "jax"), **kw)
    run = RunConfig(checkpoint_dir=str(tmp_path / "port"), **kw)
    init = jax_init_train_state(JaxModel(jax_train_mod.get_config(arch, True)), jrun,
                                jax.random.PRNGKey(jrun.seed))
    jax_save_checkpoint(run.checkpoint_dir, 0, jax.device_get(init))

    expect = jax_train_mod.train(arch, steps=steps, run=jrun, log_every=1,
                                 shape=JaxShapeConfig("t", 32, 4, "train"))
    out = train_mod.train(arch, steps=steps, run=run, log_every=1, resume=True,
                          shape=ShapeConfig("t", 32, 4, "train"), device="cpu")
    losses = np.array([h["loss"] for h in out["history"]])
    want = np.array([h["loss"] for h in expect["history"]])
    gnorms = np.array([h["grad_norm"] for h in out["history"]])
    want_gnorms = np.array([h["grad_norm"] for h in expect["history"]])
    print(f"{dtype}: losses {np.max(np.abs(losses - want) / want):.3e} relative, loss "
          f"changes {np.max(np.abs((losses - losses[0]) - (want - want[0]))):.3e} absolute "
          f"(of {np.min(np.abs(want[1:] - want[0])):.3e} to {np.max(np.abs(want - want[0])):.3e}), "
          f"grad-norms {np.max(np.abs(gnorms - want_gnorms) / want_gnorms):.3e} relative")
    assert [h["step"] for h in out["history"]] == list(range(1, steps + 1))
    np.testing.assert_allclose(losses, want, rtol=loss_rtol)
    np.testing.assert_allclose(losses - losses[0], want - want[0], rtol=0, atol=dloss_atol)
    np.testing.assert_allclose(gnorms, want_gnorms, rtol=gnorm_rtol)
    assert int(out["final_state"]["opt"]["step"]) == steps


def test_quickstart_example_learns_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "examples/quickstart_torch.py", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "(LEARNING)" in proc.stdout.splitlines()[-1]


def test_quickstart_example_learns_xlstm_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "examples/quickstart_torch.py", "--device", "cpu",
                           "--arch", "xlstm-1.3b", "--steps", "10"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "(LEARNING)" in proc.stdout.splitlines()[-1]
