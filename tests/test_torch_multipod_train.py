"""The port's multi-pod train step and ``train()`` over ranks against the
JAX package's ``build_train_step`` on a pod mesh.

JAX runs once, in a subprocess with two host devices (``conftest``'s
``run_multidevice``), on a ``(2, 1, 1)`` pod/data/model mesh: smoke llama3.2-1b
in fp32 from ``PRNGKey(0)``, three steps each of ``sync``, ``sync`` + int8
and ``local`` with budget 2, and deepseek-v2-236b (its MLA up-projections
conditioned as in ``tests/test_torch_moe_train.py``) in ``sync``.  The port
starts from the same initial parameters on 4 gloo ranks (2 pods x 2 data;
deepseek on 2 pods x 1 data, where its MoE capacity is the reference's) and
is held to the losses, grad-norms, final parameters and ``ef``.  Then
``flat`` on 4 ranks against the one-process step, a one-rank mesh against
the one-device step bit for bit, and ``train()`` over ranks: its history
against one process, its checkpoint resumed in one process, and a
``local``-mode checkpoint under JAX's ``train_state_specs(npods=2)``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import train_state_specs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_ranks  # noqa: E402
from repro_torch.launch.steps import build_train_step, grad_fn, init_train_state  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamWState, adamw_update, cosine_schedule  # noqa: E402

import torch_rank_fns  # noqa: E402
from conftest import run_multidevice  # noqa: E402

LLAMA, MOE = "llama3.2-1b", "deepseek-v2-236b"
STEPS, B, T = 3, 8, 16
RUN = dict(learning_rate=1e-3, warmup_steps=0, microbatches=2)
MODES = {"sync": dict(sync_mode="sync"),
         "int8": dict(sync_mode="sync", compress_int8=True),
         "local": dict(sync_mode="local", sync_budget=2)}
# deepseek-v2 served on 2 pods: rows, prompt length, generated tokens.
MOE_SERVE = (4, 8, 4)
# fp32 on both sides: summation order only (tests/test_torch_train.py's).
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)

JAX_REF = """
import math
import jax, numpy as np
from repro.compat import set_mesh
from repro.configs import RunConfig, ShapeConfig, get_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_train_step, init_train_state
from repro.models import Model

def flat(tree, prefix=''):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f'{prefix}.{k}' if prefix else str(k)
        out.update(flat(v, key) if isinstance(v, (dict, list, tuple)) else {key: np.asarray(v)})
    return out

def conditioned(tree):
    if isinstance(tree, dict):
        return {k: (v * math.sqrt(v.shape[-2] / v.shape[-3]) if k in ('w_uq', 'w_uk', 'w_uv')
                    else conditioned(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [conditioned(v) for v in tree]
    return tree

mesh = make_mesh((2, 1, 1), ('pod', 'data', 'model'))
res = {}
for tag, arch, kw in TAGS:
    cfg = get_config(arch, smoke=True).with_overrides(dtype='float32')
    run = RunConfig(total_steps=10, **{**RUN, **kw})
    model = Model(cfg)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (STEPS, B, T + 1))
    with set_mesh(mesh):
        step, _, state_sh, batch_sh = build_train_step(model, run, mesh, ShapeConfig('t', T, B, 'train'))
        state = jax.device_get(init_train_state(model, run, jax.random.PRNGKey(0), 2))
        if arch.startswith('deepseek'):
            state['params'] = conditioned(state['params'])
        for k, v in flat(state['params']).items():
            res[f'{tag}/init/{k}'] = v[0] if kw.get('sync_mode') == 'local' else v
        state = jax.device_put(state, state_sh)
        for i in range(STEPS):
            batch = {'tokens': toks[i, :, :-1].astype(np.int32), 'labels': toks[i, :, 1:].astype(np.int32)}
            state, m = step(state, jax.device_put(batch, batch_sh))
            for key in ('loss', 'grad_norm'):
                res.setdefault(f'{tag}/{key}', []).append(float(m[key]))
    for group in ('params', 'ef'):
        if group in state:
            for k, v in flat(jax.device_get(state[group])).items():
                res[f'{tag}/{group}/{k}'] = v
np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
print('OK ref')
"""


def _batches(arch):
    vocab = get_config(arch, smoke=True).vocab_size
    return np.random.default_rng(7).integers(0, vocab, (STEPS, B, T + 1))


def _moe_prompts():
    vocab = get_config(MOE, smoke=True).vocab_size
    return {"tokens": np.random.default_rng(3).integers(0, vocab, MOE_SERVE[:2])}


def _tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    tags = [(tag, LLAMA, kw) for tag, kw in MODES.items()]
    tags.append(("moe", MOE, {"sync_mode": "sync", "microbatches": 1}))
    head = (f"TAGS = {tags!r}\nRUN = {RUN!r}\n"
            f"SEED, STEPS, B, T, OUT = 7, {STEPS}, {B}, {T}, {str(out)!r}\n")
    assert "OK ref" in run_multidevice(head + JAX_REF, devices=2, timeout=600)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port_4(jax_ref, tmp_path_factory):
    """4 ranks, 2 pods x 2 data: the three modes and flat, then train()."""
    runs = [{**RUN, **kw} for kw in MODES.values()] + [{**RUN, "sync_mode": "flat"}]
    ckpt = str(tmp_path_factory.mktemp("ckpt_2x2"))
    train_kw = dict(**RUN, total_steps=6, checkpoint_every=4, checkpoint_dir=ckpt)
    jobs = [("step_modes", (LLAMA, (2, 2), _tree(jax_ref, "sync/init/"), _batches(LLAMA), runs)),
            ("train_fp32", (LLAMA, (2, 2), 4, train_kw))]
    return spawn_ranks(torch_rank_fns.ranks_main, 4, (jobs,), timeout=300), train_kw


@pytest.fixture(scope="module")
def port_2(jax_ref, tmp_path_factory):
    """2 ranks, 2 pods x 1 data: deepseek-v2 in sync; then train() in local
    mode and in int8 sync, 3 steps with a checkpoint at step 3, that
    checkpoint resumed through step 4, and 4 steps uninterrupted; then the
    CLI in local mode for 2 steps; then deepseek-v2 served."""
    kw = {mode: dict(**RUN, **MODES[mode], total_steps=4, checkpoint_every=3,
                     checkpoint_dir=str(tmp_path_factory.mktemp(f"ckpt_{mode}")))
          for mode in ("local", "int8")}
    jobs = [("step_modes", (MOE, (2, 1), _tree(jax_ref, "moe/init/"), _batches(MOE),
                            [{**RUN, "microbatches": 1, "sync_mode": "sync"}]))]
    for mode, run_kw in kw.items():
        whole = {**run_kw, "checkpoint_dir": run_kw["checkpoint_dir"] + "_whole"}
        jobs += [("train_fp32", (LLAMA, (2, 1), 3, run_kw)),
                 ("train_fp32", (LLAMA, (2, 1), 4, run_kw, True)),
                 ("train_fp32", (LLAMA, (2, 1), 4, whole))]
    cli_dir = str(tmp_path_factory.mktemp("ckpt_cli"))
    jobs.append(("cli_main", ([
        "--arch", LLAMA, "--steps", "2", "--seq-len", "16", "--batch", "8",
        "--ckpt-dir", cli_dir, "--mesh-shape", "2,1", "--mesh-axes", "pod,data",
        "--sync-mode", "local", "--device", "cpu"],)))
    jobs.append(("pod_serve", (MOE, (2, 1), _tree(jax_ref, "moe/init/"), _moe_prompts(),
                               *MOE_SERVE, torch_rank_fns.POD_DATA)))
    ranks = spawn_ranks(torch_rank_fns.ranks_main, 2, (jobs,), timeout=300)
    return ranks, {**kw, "cli": cli_dir}


def _close_to_jax(got, ref, tag, pod, group="params", **tol):
    want = _tree(ref, f"{tag}/{group}/")
    assert set(got) == set(want)
    for key, w in want.items():
        w = w[pod] if w.shape != got[key].shape else w
        np.testing.assert_allclose(got[key], w, err_msg=f"{tag} {group} {key}", **tol)


@pytest.mark.parametrize("mode", ["sync", "local"])
def test_pod_modes_match_jax(port_4, jax_ref, mode):
    """Each rank's losses, grad-norms and final parameters against JAX's
    (in local mode its own pod's: the pods part after steps 1 and 3)."""
    ranks, _ = port_4
    i = list(MODES).index(mode)
    for rank in ranks:
        res = rank[0]["runs"][i]
        np.testing.assert_allclose(res["loss"], jax_ref[f"{mode}/loss"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], jax_ref[f"{mode}/grad_norm"], rtol=1e-5)
        _close_to_jax(res["params"], jax_ref, mode, rank[0]["coords"]["pod"],
                      **GRAD_TOL)
    if mode == "local":
        pods = [r[0]["runs"][i]["params"] for r in ranks[::2]]
        assert any(not np.array_equal(pods[0][k], pods[1][k]) for k in pods[0])


def _outside(got, want, atol, rtol):
    return np.abs(got - want) > atol + rtol * np.abs(want)


def test_int8_sync_matches_jax(port_4, jax_ref):
    """sync with int8 on the pod hop: the losses, grad-norms, final
    parameters and each pod's ef against JAX's.  The quantiser rounds
    y / scale, so where the two frameworks' y (equal up to fp32 summation
    order) straddle a half-integer, q differs by one level (a flip): that
    element's pod mean moves by scale / P and its residual by scale, which
    error feedback hands to the next step.  So the elements outside GRAD_TOL
    must be rare (under 1 in 2000, in ef and in the parameters), an ef
    element off by at most one level (the residual is at most half a level,
    so a level is at least 2 max |ef| of its leaf), and a parameter by at
    most 3 lr (an AdamW step moves an element by about lr; three steps)."""
    ranks, _ = port_4
    lr = RUN["learning_rate"]
    for rank in ranks:
        res = rank[0]["runs"][list(MODES).index("int8")]
        pod = rank[0]["coords"]["pod"]
        np.testing.assert_allclose(res["loss"], jax_ref["int8/loss"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], jax_ref["int8/grad_norm"], rtol=1e-5)
        flips = {"ef": 0, "params": 0}
        total = 0
        for key, got in res["ef"].items():
            want = jax_ref[f"int8/ef/{key}"][pod]
            p, w = res["params"][key], jax_ref[f"int8/params/{key}"]
            off, p_off = _outside(got, want, **GRAD_TOL), _outside(p, w, **GRAD_TOL)
            assert np.all(np.abs(got - want)[off] <= 2.02 * np.abs(want).max()), key
            assert np.all(np.abs(p - w)[p_off] <= 3 * lr), key
            flips["ef"] += int(off.sum())
            flips["params"] += int(p_off.sum())
            total += off.size
        print(f"int8, pod {pod}: elements outside GRAD_TOL {flips} of {total}")
        assert max(flips.values()) < total / 2000, flips


def test_moe_sync_at_data_1_matches_jax(port_2, jax_ref):
    """deepseek-v2 on 2 pods x 1 data, where each rank routes the rows the
    reference's pod does: losses, grad-norms and final parameters.  AdamW
    divides each moment by the root of the second: an element whose
    gradients are near zero turns their fp32 differences into a difference
    of its update near lr (as chip_smoke.py's SMOKE_MLA_LR notes for
    deepseek-v3's embedding).  A CPU run of this test read 3 such elements of
    237232 (in the lead layer's FFN and the MoE layer's attention output)
    outside GRAD_TOL, the largest 0.13 lr off; so elements outside GRAD_TOL
    must be under 1 in 10^4 and within lr / 2."""
    ranks, _ = port_2
    lr = RUN["learning_rate"]
    for rank in ranks:
        res = rank[0]["runs"][0]
        np.testing.assert_allclose(res["loss"], jax_ref["moe/loss"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], jax_ref["moe/grad_norm"], rtol=1e-5)
        want = _tree(jax_ref, "moe/params/")
        assert set(res["params"]) == set(want)
        off = total = 0
        for key, got in res["params"].items():
            outside = _outside(got, want[key], **GRAD_TOL)
            assert np.all(np.abs(got - want[key])[outside] <= lr / 2), key
            off += int(outside.sum())
            total += got.size
        assert off < total / 10 ** 4, (off, total)


def test_moe_serves_on_two_pods_as_on_one_rank(port_2, jax_ref):
    """serve() of deepseek-v2 (fp32) on 2 pods x 1 data: every rank serves
    its pod's half of the batch on a whole replica, its MoE groups spanning
    both pods' rows as the reference's span (pod, data), and its tokens are
    the port's one-rank tokens."""
    ranks, _ = port_2
    want, _ = torch_rank_fns.pod_serve(MOE, (1, 1), _tree(jax_ref, "moe/init/"),
                                       _moe_prompts(), *MOE_SERVE, torch_rank_fns.DATA_MODEL)
    for rank in ranks:
        tokens, rows = rank[-1]
        np.testing.assert_array_equal(tokens, want)
        assert rows == [MOE_SERVE[0] // 2]


def _one_process(arch, params, run, batches):
    """The port's one-device steps from ``params`` over ``batches``."""
    model = torch_rank_fns._model(arch, params)
    state, step = init_train_state(model, run), build_train_step(model, run)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b[:, :-1]).long(),
                                "labels": torch.from_numpy(b[:, 1:]).long()})
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, {k: v.detach().numpy() for k, v in state["params"].items()}


def test_flat_on_four_ranks_matches_one_process(port_4, jax_ref):
    """flat: each rank's share of every microbatch, one all-reduce mean."""
    ranks, _ = port_4
    losses, norms, params = _one_process(LLAMA, _tree(jax_ref, "sync/init/"),
                                         RunConfig(total_steps=10, **RUN, sync_mode="flat"),
                                         _batches(LLAMA))
    for rank in ranks:
        res = rank[0]["runs"][len(MODES)]
        np.testing.assert_allclose(res["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], norms, rtol=1e-5)
        for key, p in params.items():
            np.testing.assert_allclose(res["params"][key], p, err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("mode", ["flat", "sync", "local"])
def test_one_rank_mesh_is_the_one_device_step_bit_for_bit(mode):
    """A mesh of one rank, with int8 asked for in sync: no collective, and
    the bits of grad_fn then adamw_update, the one-device step."""
    params = {k: v.detach().numpy() for k, v in Model(
        get_config(LLAMA, smoke=True).with_overrides(dtype="float32"), device="cpu"
    ).state_dict().items()}
    run = RunConfig(total_steps=10, **RUN, sync_mode=mode, compress_int8=mode == "sync")
    mesh = make_mesh((1, 1), ("pod", "data"), "cpu")
    model, plain = (torch_rank_fns._model(LLAMA, params) for _ in range(2))
    state, step = init_train_state(model, run, mesh), build_train_step(model, run, mesh)
    assert "ef" not in state
    pstate = init_train_state(plain, run)
    grads_of = grad_fn(plain, run.microbatches)
    for b in _batches(LLAMA):
        batch = {"tokens": torch.from_numpy(b[:, :-1]).long(),
                 "labels": torch.from_numpy(b[:, 1:]).long()}
        state, m = step(state, batch)
        loss, _, grads = grads_of(batch)
        opt = AdamWState(pstate["opt"]["step"], pstate["opt"]["mu"], pstate["opt"]["nu"])
        lr = cosine_schedule(opt.step, peak_lr=run.learning_rate, warmup=run.warmup_steps,
                             total=run.total_steps)
        opt, om = adamw_update(pstate["params"], grads, opt, lr,
                               weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        pstate["opt"]["step"] = opt.step
        assert m["loss"].item() == loss.item()
        assert m["grad_norm"].item() == om["grad_norm"].item()
    assert not mesh.traffic.calls
    for key, p in pstate["params"].items():
        assert torch.equal(state["params"][key], p), key


def test_train_over_ranks_matches_one_process_and_resumes_in_one(port_4, tmp_path, monkeypatch):
    """train() on 2 pods x 2 data (num_hosts 2), sync: its four steps' history
    equals one process's; its one checkpoint (step 4) resumes in one process
    through step 6 as an uninterrupted one-process run goes."""
    from repro_torch.launch import train as train_mod

    ranks, train_kw = port_4
    real = train_mod.get_config
    monkeypatch.setattr(train_mod, "get_config",
                        lambda a, smoke: real(a, smoke).with_overrides(dtype="float32"))
    one = lambda steps, **kw: train_mod.train(
        LLAMA, steps=steps, shape=torch_rank_fns.ShapeConfig("t", 16, 8, "train"),
        run=RunConfig(**{**train_kw, **kw}), log_every=1, device="cpu")["history"]
    whole = one(6, checkpoint_dir=str(tmp_path / "whole"))
    resumed = train_mod.train(
        LLAMA, steps=6, shape=torch_rank_fns.ShapeConfig("t", 16, 8, "train"),
        run=RunConfig(**train_kw), log_every=1, resume=True, device="cpu")["history"]
    for rank in ranks:
        hist = rank[1]
        assert [h["step"] for h in hist] == [1, 2, 3, 4]
        assert set(hist[0]["wire_bytes"]) == {"pod", "data", "world"}
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([h[key] for h in hist], [h[key] for h in whole[:4]],
                                       rtol=1e-5, err_msg=key)
    assert [h["step"] for h in resumed] == [5, 6]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in resumed], [h[key] for h in whole[4:]],
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode", ["local", "int8"])
def test_pod_checkpoint_has_the_references_layout_and_resumes(port_2, mode):
    """train() on 2 pods, local mode or int8 sync: the checkpoint that rank 0
    wrote at step 3 loads under JAX's train_state_specs(npods=2) (a leading
    pod dim on every leaf in local mode, the step count [2]; on ef under
    int8); each pod's slice holds that pod's own values; resumed on both
    ranks through step 4, it gives an uninterrupted run's step 4 exactly."""
    from repro_torch.convert import train_state_from_jax

    ranks, kw = port_2
    run_kw = kw[mode]
    run = JaxRunConfig(**{k: v for k, v in run_kw.items() if k != "checkpoint_dir"})
    model = JaxModel(jax_config(LLAMA, smoke=True).with_overrides(dtype="float32"))
    shapes, _ = train_state_specs(model, run, npods=2)
    state, step, _ = jax_load_checkpoint(run_kw["checkpoint_dir"], shapes, step=3)
    assert step == 3
    state = jax.device_get(state)
    np.testing.assert_array_equal(np.asarray(state["opt"]["step"]),
                                  [3, 3] if mode == "local" else 3)
    pods = [train_state_from_jax(state, pod=p) for p in (0, 1)]
    group = "params" if mode == "local" else "ef"
    want = {k: v.shape for k, v in Model(get_config(LLAMA, smoke=True), device="cpu")
            .state_dict().items()}
    for pod in pods:
        assert {k: t.shape for k, t in pod[group].items()} == want
    assert any(not torch.equal(pods[0][group][k], pods[1][group][k]) for k in pods[0][group])
    with pytest.raises(ValueError, match="name the pod"):
        train_state_from_jax(state)
    i = 1 + 3 * list(kw).index(mode)
    for rank in ranks:
        first, resumed, whole = rank[i:i + 3]
        assert [h["step"] for h in first] == [1, 2, 3]
        assert [h["step"] for h in resumed] == [4]
        assert [h["loss"] for h in first] == [h["loss"] for h in whole[:3]]
        assert resumed[0]["loss"] == whole[3]["loss"]
        assert resumed[0]["grad_norm"] == whole[3]["grad_norm"]


def test_cli_sync_mode_trains_in_pods(port_2):
    """The CLI on 2 ranks with --sync-mode local over a 2-pod mesh writes
    local mode's layout: under JAX's train_state_specs(npods=2), a leading
    pod dim on every parameter, the step count [2, 2]."""
    from repro_torch.convert import train_state_from_jax

    _, kw = port_2
    run = JaxRunConfig(sync_mode="local", total_steps=2)
    model = JaxModel(jax_config(LLAMA, smoke=True))
    shapes, _ = train_state_specs(model, run, npods=2)
    state, step, _ = jax_load_checkpoint(kw["cli"], shapes, step=2)
    assert step == 2
    state = jax.device_get(state)
    np.testing.assert_array_equal(np.asarray(state["opt"]["step"]), [2, 2])
    want = {k: v.shape for k, v in Model(get_config(LLAMA, smoke=True), device="cpu")
            .state_dict().items()}
    for pod in (0, 1):
        got = train_state_from_jax(state, pod=pod)["params"]
        assert {k: t.shape for k, t in got.items()} == want


def test_cli_refuses_a_sync_mode_without_pods(capsys):
    """--sync-mode other than flat on a mesh with no pod axis above 1 would
    run flat: the CLI refuses it."""
    from repro_torch.launch import train as train_mod

    with pytest.raises(SystemExit):
        train_mod.main(["--arch", LLAMA, "--sync-mode", "local", "--device", "cpu"])
    assert "needs a pod axis" in capsys.readouterr().err


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only inside main)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_7_rehearses_at_smoke_width_on_the_cpu():
    """chip_smoke.py's phase 7 end to end at smoke width (bf16) on 2 CPU
    ranks: every mode through train(), and its checks pass; they fail when
    the local pods' parameters do not part, a step counts other bytes, or
    the planted fault's loss is sync's."""
    import copy

    cs = _chip_smoke()
    arch, rows, _, micro, n_steps, lr = cs.POD_TRAIN
    ranks = spawn_ranks(torch_rank_fns.chip_smoke_pod_rank, 2,
                        (arch, rows, 32, micro, n_steps, lr, True, "cpu"), timeout=300)
    losses = cs.check_pod_training(ranks, None, None, "cpu")
    assert set(losses) == {m for m, _ in cs.POD_MODES}
    assert all(len(v) == n_steps and all(map(math.isfinite, v)) for v in losses.values())
    local = [m["mode"] for m in ranks[0]].index("local")
    stuck = copy.deepcopy(ranks)
    stuck[1][local]["steps"][0]["digest"] = stuck[0][local]["steps"][0]["digest"]
    with pytest.raises(AssertionError, match="parameters equal"):
        cs.check_pod_training(stuck, None, None, "cpu")
    extra = copy.deepcopy(ranks)
    extra[0][0]["history"][1]["wire_bytes"]["world"] += 4
    with pytest.raises(AssertionError, match="wire bytes"):
        cs.check_pod_training(extra, None, None, "cpu")
    modes = [m["mode"] for m in ranks[0]]
    fault, sync = modes.index(cs.POD_FAULT[0]), modes.index("sync")
    assert ranks[0][fault]["history"][0]["loss"] != losses["sync"][0]
    blind = copy.deepcopy(ranks)
    blind[0][fault]["history"][0]["loss"] = blind[0][sync]["history"][0]["loss"]
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_pod_training(blind, None, None, "cpu")
