"""The port's serving entry point, its example, chip_smoke.py's refusals,
and the rule that the port imports nothing of JAX or of the JAX package."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.serve import serve  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


def _run(args, cwd=REPO, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_on_cpu_returns_jax_keys():
    from repro.launch.serve import serve as jax_serve

    expect = jax_serve("llama3.2-1b", batch=2, prompt_len=8, gen_len=3)
    out = serve("llama3.2-1b", batch=2, prompt_len=8, gen_len=3, device="cpu")
    assert set(out) == set(expect)
    assert tuple(out["tokens"].shape) == (2, 3) == expect["tokens"].shape
    assert out["tokens"].dtype == torch.int64
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < 256)).all())
    assert out["prefill_seconds"] > 0 and out["throughput_tok_s"] > 0


def test_serve_recurrentgemma_on_cpu():
    """The hybrid serves through the same entry: 12 prompt tokens, decode past
    the smoke window of 16."""
    out = serve("recurrentgemma-9b", batch=2, prompt_len=12, gen_len=8, device="cpu")
    assert tuple(out["tokens"].shape) == (2, 8) and out["tokens"].dtype == torch.int64
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < 256)).all())


def test_serve_deepseek_on_cpu():
    """MLA and MoE serve through the same entry: a dense lead layer, two MoE
    layers, the latent caches."""
    out = serve("deepseek-v2-236b", batch=2, prompt_len=12, gen_len=5, device="cpu")
    assert tuple(out["tokens"].shape) == (2, 5) and out["tokens"].dtype == torch.int64
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < 256)).all())


def test_serve_xlstm_on_cpu():
    """mLSTM and sLSTM blocks serve through the same entry: a prompt of 13
    (no multiple of the smoke chunk of 8), their states carried in place
    through decode; the same seed serves the same tokens."""
    out = serve("xlstm-1.3b", batch=2, prompt_len=13, gen_len=5, device="cpu", seed=1)
    assert tuple(out["tokens"].shape) == (2, 5) and out["tokens"].dtype == torch.int64
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < 256)).all())
    again = serve("xlstm-1.3b", batch=2, prompt_len=13, gen_len=5, device="cpu", seed=1)
    assert torch.equal(out["tokens"], again["tokens"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serve_deepseek_on_card_launches_flash_per_layer(cuda):
    """deepseek-v2 at smoke size on the card: each of its 3 MLA layers
    launches the flash kernel once in prefill (bf16, dk 24 / dv 16: the
    wgmma variant), decode launches none, and no plain version runs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    before = dict(flash_attention_fwd.launches_by_variant)
    plain = [name for name in dir(ref) if name.endswith("_ref")]
    real = {name: getattr(ref, name) for name in plain}
    calls = []
    try:
        for name in plain:
            setattr(ref, name, lambda *a, _n=name, **k: calls.append(_n) or real[_n](*a, **k))
        out = serve("deepseek-v2-236b", batch=2, prompt_len=16, gen_len=4, device="cuda")
    finally:
        for name, fn in real.items():
            setattr(ref, name, fn)
    launched = {k: c - before[k] for k, c in flash_attention_fwd.launches_by_variant.items()}
    assert launched == {"simt": 0, "wgmma": 3}
    assert calls == []
    assert tuple(out["tokens"].shape) == (2, 4)


def test_serve_internvl2_on_cpu():
    """The vision stub serves through the same entry: a prompt of 16
    positions is 4 image embeddings then 12 text tokens, and decode goes on
    from it; the same seed serves the same tokens."""
    kw = dict(batch=2, prompt_len=16, gen_len=4, device="cpu", seed=2)
    out = serve("internvl2-76b", **kw)
    assert tuple(out["tokens"].shape) == (2, 4) and out["tokens"].dtype == torch.int64
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < 256)).all())
    assert torch.equal(out["tokens"], serve("internvl2-76b", **kw)["tokens"])


def test_serve_is_reproducible_from_seed():
    kw = dict(batch=3, prompt_len=10, gen_len=5, device="cpu")
    a = serve("llama3.2-1b", seed=4, **kw)["tokens"]
    assert torch.equal(a, serve("llama3.2-1b", seed=4, **kw)["tokens"])
    s1 = serve("llama3.2-1b", seed=4, greedy=False, **kw)["tokens"]
    s2 = serve("llama3.2-1b", seed=4, greedy=False, **kw)["tokens"]
    assert torch.equal(s1, s2) and tuple(s1.shape) == (3, 5)


def test_serve_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: serve() would run on it")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        serve("llama3.2-1b", batch=1, prompt_len=4, gen_len=2)


def test_serve_refuses_encoder_only():
    with pytest.raises(ValueError, match="encoder-only"):
        serve("hubert-xlarge", device="cpu")


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
        "assert {'repro_torch.optim.adamw', 'repro_torch.data.pipeline',\n"
        "        'repro_torch.checkpoint.ckpt', 'repro_torch.launch.train',\n"
        "        'repro_torch.models.moe', 'repro_torch.sharding.rules',\n"
        "        'repro_torch.sharding.shard', 'repro_torch.launch.dryrun',\n"
        "        'repro_torch.launch.roofline', 'repro_torch.core.modelcheck',\n"
        "        'repro_torch.sim.workloads', 'repro_torch.kernels.work'} <= set(names)\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 68


def test_port_sources_name_no_jax_or_repro_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)(\.|\s|$)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "examples/serve_batch_torch.py",
        REPO / "examples/quickstart_torch.py", REPO / "examples/lock_service_torch.py",
        REPO / "examples/train_lm_torch.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_example_runs_on_cpu():
    proc = _run(["examples/serve_batch_torch.py", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4"])
    assert proc.returncode == 0, proc.stderr
    assert "generated 2 sequences x 4 tokens" in proc.stdout


def test_train_lm_example_runs_on_cpu(tmp_path):
    proc = _run(["examples/train_lm_torch.py", "--tiny", "--steps", "3", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[train] step 3/3" in proc.stdout and "[train_lm] loss" in proc.stdout


def test_lock_service_example_runs_over_the_port():
    proc = _run(["examples/lock_service_torch.py"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "rejected zombie writes" in proc.stdout
    assert "OK: home readers paid 0 RDMA ops" in proc.stdout


def test_example_serves_recurrentgemma_on_cpu():
    proc = _run(["examples/serve_batch_torch.py", "--arch", "recurrentgemma-9b",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert proc.returncode == 0, proc.stderr
    assert "generated 2 sequences x 3 tokens on cpu" in proc.stdout


def test_example_serves_deepseek_on_cpu():
    proc = _run(["examples/serve_batch_torch.py", "--arch", "deepseek-v2-236b",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    assert proc.returncode == 0, proc.stderr
    assert "generated 2 sequences x 3 tokens on cpu" in proc.stdout


def test_example_serves_xlstm_on_cpu():
    proc = _run(["examples/serve_batch_torch.py", "--arch", "xlstm-1.3b",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "11", "--gen", "3"])
    assert proc.returncode == 0, proc.stderr
    assert "generated 2 sequences x 3 tokens on cpu" in proc.stdout


def test_example_serves_internvl2_on_cpu():
    proc = _run(["examples/serve_batch_torch.py", "--arch", "internvl2-76b",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    assert proc.returncode == 0, proc.stderr
    assert "generated 2 sequences x 3 tokens on cpu" in proc.stdout


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Alone in a directory the script has no port to run; without a card it
    refuses before printing any result."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    runs = [_run([str(lone)], cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(_run(["chip_smoke.py"]))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
