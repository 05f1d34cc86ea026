"""The port's dry run and roofline against the JAX package's: the same
production tables and model FLOPs, each rank's train-state bytes as the
reference's specs and sharding rules give them, FLOPs on the ``meta`` device
equal to those counted over the real CPU step, the roofline's formulas on an
H100's constants, and one CLI cell."""

import contextlib
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, SHAPES, RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.steps import (build_encode_step, build_train_step,  # noqa: E402
                                      init_train_state)
from repro_torch.models import Model, input_specs, rank_inputs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module, imported without its process-wide
    ``XLA_FLAGS`` (it sets 512 host devices before importing JAX)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


def _plain(x):
    import dataclasses

    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("arch", ARCHS)
def test_production_tables_and_model_flops_equal_the_reference(arch, ref_dryrun):
    from repro.models import Model as JaxModel
    from repro.models import param_count

    cfg = dryrun.production_config(arch)
    assert _plain(cfg) == _plain(ref_dryrun.production_config(arch))
    for mode in ("flat", "sync", "local"):
        for mp in (False, True):
            assert (_plain(dryrun.production_run(arch, mode, multi_pod=mp))
                    == _plain(ref_dryrun.production_run(arch, mode, multi_pod=mp)))
    jcfg = ref_dryrun.production_config(arch)
    n = param_count(JaxModel(jcfg).specs())
    assert dryrun._routed_expert_fraction(cfg) == ref_dryrun._routed_expert_fraction(jcfg)
    for name, shape in SHAPES.items():
        from repro.configs import SHAPES as JAX_SHAPES

        assert (dryrun.model_flops_estimate(cfg, shape, n)
                == ref_dryrun.model_flops_estimate(jcfg, JAX_SHAPES[name], n)), name


def _reference_state_bytes(ref_dryrun, arch, multi_pod):
    """A rank's train-state bytes from the reference's ``train_state_specs``
    and its fitted partition specs at the production mesh's sizes."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.launch.steps import train_state_specs
    from repro.models import Model as JaxModel
    from repro.sharding.rules import fit_pspec

    sizes = MESHES[multi_pod]
    run = ref_dryrun.production_run(arch, "sync", multi_pod=multi_pod)
    shapes, specs = train_state_specs(JaxModel(ref_dryrun.production_config(arch)), run,
                                      2 if multi_pod else 1)
    fake = types.SimpleNamespace(shape=sizes)
    total = 0
    for s, ps in zip(jax.tree.leaves(shapes),
                     jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        split = 1
        for entry in fit_pspec(ps, s.shape, fake):
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                split *= sizes[a]
        total += math.prod(s.shape) * s.dtype.itemsize // split
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_train_state_bytes_equal_the_reference_rules(multi_pod, ref_dryrun):
    for arch in ARCHS:
        if arch == "xlstm-1.3b":
            with pytest.raises(NotImplementedError, match="do not all divide by model 16"):
                dryrun.build_rank(arch, "train_4k", multi_pod, "sync")
            continue
        _, _, mesh, run, model = dryrun.build_rank(arch, "train_4k", multi_pod, "sync")
        got = dryrun.tree_bytes(init_train_state(model, run, mesh))
        assert got == _reference_state_bytes(ref_dryrun, arch, multi_pod), arch


def test_refused_cell_is_written_skipped(tmp_path):
    rec = dryrun.run_cell("xlstm-1.3b", "train_4k", False, "sync", str(tmp_path))
    assert rec["skipped"].startswith("refused: xlstm-1.3b: query heads 4")
    assert json.loads((tmp_path / (rec["cell"] + ".json")).read_text()) == rec


# ----------------------------------------------------- FLOPs on meta --
@contextlib.contextmanager
def _kernels_as_work(monkeypatch):
    """On the CPU, each kernel entry point's plain version hidden from the
    counters and its work recorded, as on ``meta``; its outputs contiguous,
    as the kernels' are."""
    from torch.utils._python_dispatch import _disable_current_modes

    def hidden(fn, name, work_of):
        def run(*args, **kw):
            with _disable_current_modes():
                out = fn(*args, **kw)
                out = (tuple(t.contiguous() for t in out) if isinstance(out, tuple)
                       else out.contiguous())
            work.record(name, work_of(*args, **kw))
            return out
        return run

    monkeypatch.setattr(ops, "_flash_fwd", hidden(
        ops._flash_fwd, "flash_attention",
        lambda q, k, v, causal, window, scale, lse=False: work.flash_fwd_work(
            q, k, v, causal, window, lse)))
    monkeypatch.setattr(ops, "_flash_bwd", hidden(
        ops._flash_bwd, "flash_attention_bwd",
        lambda q, k, v, o, lse, g, causal, window, scale: work.flash_bwd_work(
            q, k, v, causal, window)))
    monkeypatch.setattr(ops, "_scan_fwd", hidden(
        ops._scan_fwd, "rglru_scan", lambda a, b, h0: work.scan_fwd_work(a, h0)))
    monkeypatch.setattr(ops, "_scan_bwd", hidden(
        ops._scan_bwd, "rglru_scan_bwd", lambda a, h, h0, g: work.scan_bwd_work(a, h0)))
    yield


def _cpu_step(arch, cfg, shape, run):
    """The same step as :func:`dryrun.run_rank`'s on one CPU rank, counted
    by ``StepCounter`` and, for its FLOPs, by ``FlopCounterMode`` and the
    kernels' work beside it."""
    sizes = {"data": 1, "model": 1}
    mesh = Mesh(axes=("data", "model"), shape=sizes, coords={"data": 0, "model": 0},
                device=torch.device("cpu"))
    model = Model(cfg, mesh=mesh, generator=torch.Generator("cpu").manual_seed(0))
    gen = torch.Generator("cpu").manual_seed(1)
    batch = input_specs(cfg, shape, generator=gen, device=torch.device("cpu"))
    if shape.kind == "train":
        state, step = init_train_state(model, run, mesh), build_train_step(model, run, mesh)
        with roofline.StepCounter() as counted, _flop_counter(counted):
            step(state, batch)
    elif shape.kind == "prefill":
        with roofline.StepCounter() as counted, _flop_counter(counted):
            if cfg.causal:
                model.prefill(rank_inputs(batch, cfg, shape, mesh), shape.seq_len)
            else:
                build_encode_step(model, mesh)(batch)
    else:
        caches = model.cache(shape.global_batch, shape.seq_len)
        with roofline.StepCounter() as counted, _flop_counter(counted):
            model.decode_step(caches, batch["tokens"])
    return counted


@contextlib.contextmanager
def _flop_counter(counted):
    from torch.utils.flop_counter import FlopCounterMode

    with work.recorded() as rec, FlopCounterMode(display=False) as mode:
        yield
    counted.reference_flops = mode.get_total_flops() + rec["flops"]


FLOP_CELLS = [(a, kind) for a in ("llama3.2-1b", "recurrentgemma-9b", "deepseek-v2-236b",
                                  "xlstm-1.3b") for kind in ("train", "prefill", "decode")]
FLOP_CELLS += [("hubert-xlarge", "train"), ("hubert-xlarge", "prefill")]


@pytest.mark.parametrize("arch,kind", FLOP_CELLS)
def test_meta_flops_equal_the_cpu_steps(arch, kind, monkeypatch):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("t", 32, 4, kind)
    _, _, _, run, _, meta = dryrun.run_rank(arch, shape, False, "sync", microbatches=2,
                                            cfg=cfg, mesh_shape=((1, 1), ("data", "model")))
    with _kernels_as_work(monkeypatch):
        cpu = _cpu_step(arch, cfg, shape, run)
    assert meta.flops > 0 and meta.flops == cpu.flops == cpu.reference_flops
    assert meta.bytes == cpu.bytes
    assert meta.kernels == cpu.kernels
    if kind != "decode" and arch != "xlstm-1.3b":
        assert meta.kernels  # the step launched its kernels


def test_kernel_work_skips_masked_pairs():
    assert work.attn_pairs(6, 6, True, 0) == 21
    assert work.attn_pairs(6, 6, False, 0) == 36
    assert work.attn_pairs(6, 6, True, 2) == 11
    assert work.attn_pairs(3, 5, False, 2) == 5 + 5 + 4  # keys past i - 2, the later ones too
    q = torch.empty(2, 6, 4, 8, device="meta")
    kv = torch.empty(2, 6, 2, 8, device="meta")
    with work.recorded() as rec:
        ops.flash_attention(q, kv, kv)
    assert rec["calls"] == {"flash_attention": 1}
    assert rec["flops"] == 2 * 16 * 2 * 4 * 21
    assert rec["bytes"] == 4 * (2 * 6 * 4 * 8 * 2 + 2 * 2 * 6 * 2 * 8)


# ------------------------------------------------------------ roofline --
def test_roofline_terms_are_the_reference_formulas_on_h100_constants():
    from repro.launch import roofline as ref

    rec = {"cell": "x", "num_devices": 256, "model_flops": 2.56e18,
           "memory_analysis": {"peak_estimate_bytes_per_device": 81e9},
           "parsed": {"flops_per_device": 2e16, "hbm_bytes_per_device": 4e13,
                      "ici_wire_bytes_per_chip": 9e11, "dcn_wire_bytes_per_chip": 1e11}}
    got, want = roofline.roofline_terms(rec), ref.roofline_terms(rec)
    hw, tpu = roofline.HW, ref.HW
    assert got["compute_s"] == pytest.approx(want["compute_s"] * tpu.peak_flops_bf16
                                             / hw.peak_flops_bf16)
    assert got["compute_s"] == pytest.approx(2e16 / 989e12)
    assert got["memory_s"] == pytest.approx(4e13 / 3.35e12)
    assert got["collective_s"] == pytest.approx(9e11 / 450e9 + 1e11 / 50e9)
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    assert got["dominant"] == "compute" and not got["fits_hbm"]
    assert set(got) == set(want)
    rows = [got, {"cell": "y", "skipped": "why"}]
    assert "SKIP: why" in roofline.format_table(rows)


def test_cli_cell_and_roofline_report(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
           "--shape", "train_4k", "--single-pod", "--out", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads((tmp_path / "llama3.2-1b__train_4k__16x16__sync.json").read_text())
    assert rec["num_devices"] == 256 and rec["parsed"]["flops_per_device"] > 0
    assert rec["kernel_launches"] == {"flash_attention": 64, "flash_attention_bwd": 32}
    assert set(rec["collectives"]) == {"data@nvlink", "model@nvlink", "world@nvlink"}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--results",
                           str(tmp_path)], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and "llama3.2-1b__train_4k__16x16__sync" in proc.stdout
