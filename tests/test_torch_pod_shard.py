"""Pods combined with FSDP and tensor parallelism: the reference's ``(pod,
data, model)`` mesh over gloo ranks, against the JAX package's
``build_train_step`` and ``serve`` loop on the same meshes.

JAX runs in four subprocesses with four host devices each (``conftest``'s
``run_multidevice``), its tasks split over them, in fp32 from
``PRNGKey(0)``'s jitted init: smoke llama3.2-1b on ``(2, 1, 2)`` in flat,
sync, sync + int8 and local (budget 2), and on ``(2, 2, 1)`` in sync and sync + int8, 2 steps each;
smoke deepseek-v2-236b (its MLA up-projections conditioned as in
``tests/test_torch_moe_train.py``) on ``(2, 1, 2)`` and ``(2, 2, 1)`` in sync,
and in flat at capacity factor 0.5 (``FLAT_MOE``: the island on ``(2, 1,
2)``; one group over the 4 row ranks and 2 groups over 2 each on ``(2, 2,
1)``), 2 steps each; the greedy tokens of llama's prefill and decode steps
on ``(2, 1, 2)``; and deepseek-v2's at capacity factor 0.5 on ``(2, 2, 1)``
with the prefill's and first decode step's logits.  Beside it the port runs
on 4 gloo ranks from the same parameters, where every pod holds its ``(data,
model)`` blocks and only they cross ``pod``: those steps, int8 with a scale
per block (a planted quantiser that must miss JAX's ``ef``), flat MoE with
each pod's rows routed alone (a planted group over one pod that must miss
JAX's), ``serve()`` of llama and of deepseek, and a local-mode ``train()``
whose checkpoint, written on ``(2, 1, 2)``, loads under JAX's
``train_state_specs(npods=2)`` and resumes on ``(2, 2, 1)`` and on one
rank.  A second spawn rehearses ``chip_smoke.py``'s phases 11 and 12 at
smoke width.  The mesh's groups on ``(2, 2, 2)`` are checked without
spawning 8 ranks."""

import copy
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import init_train_state as jax_train_state  # noqa: E402
from repro.launch.steps import train_state_specs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.data import SyntheticLMDataset, make_batch_iterator  # noqa: E402
from repro_torch.launch.mesh import Mesh, group_ranks, group_spans, spawn_ranks  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import (build_train_step, init_train_state,  # noqa: E402
                                      rank_rows, restore_train_state)
from repro_torch.models import Model, input_specs  # noqa: E402

import torch_rank_fns  # noqa: E402
from conftest import run_multidevice  # noqa: E402

LLAMA, MOE = "llama3.2-1b", "deepseek-v2-236b"
AXES = torch_rank_fns.POD_DATA_MODEL
STEPS, B, T = 2, 8, 16
# One microbatch: JAX compiles each step in half the time.  lr 1e-4 as in
# tests/test_torch_tp_recurrent.py: at 1e-3, fp32 summation order alone (FSDP
# and TP against GSPMD) moves an element whose gradients sit near AdamW's eps
# by up to 2e-5 after two steps (blocks.b0.ffn.wo read 1.9e-5 here).
RUN = dict(learning_rate=1e-4, warmup_steps=0, microbatches=1)
MODES = {"flat": dict(sync_mode="flat"), "sync": dict(sync_mode="sync"),
         "int8": dict(sync_mode="sync", compress_int8=True),
         "local": dict(sync_mode="local", sync_budget=2)}
D2_MODES = ("sync", "int8")  # on (2, 2, 1): FSDP's fragment and its int8 scale
SERVE = dict(batch=4, prompt_len=8, gen_len=4)
# fp32 on both sides: summation order only (tests/test_torch_train.py's).
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# Flat MoE over pods (the reference's production layout for its MoE archs,
# src/repro/launch/dryrun.py) at capacity factor 0.5, where choices drop, so
# that a group over one pod's rows differs from one over (pod, data): the
# island on (2, 1, 2); on (2, 2, 1) one group over the 4 row ranks, and 2
# groups, each over 2 of them (the production config's 16 groups over 32
# row ranks, cut to size).
DROP = {"capacity_factor": 0.5}
FLAT_MOE = {"moe-flat-a2a": ((2, 1, 2), {**DROP, "expert_sharding": "ep_a2a"}),
            "moe-flat-d2": ((2, 2, 1), DROP), "moe-flat-g2": ((2, 2, 1), {**DROP, "groups": 2})}
# The reference's (tag, arch, mesh, run fields, MoE fields), run in one
# subprocess.
TAGS = ([(m, LLAMA, (2, 1, 2), kw, None) for m, kw in MODES.items()]
        + [(f"{m}-d2", LLAMA, (2, 2, 1), MODES[m], None) for m in D2_MODES]
        + [("moe", MOE, (2, 1, 2), MODES["sync"], None),
           ("moe-d2", MOE, (2, 2, 1), MODES["sync"], None)]
        + [(t, MOE, mesh, MODES["flat"], moe) for t, (mesh, moe) in FLAT_MOE.items()])
# chip_smoke.py's phase 11 at smoke width (bf16): served (rows, prompt,
# generated tokens: phase 8's rehearsal's request) and trained (rows, tokens
# per row, microbatches a rank, steps a mode, peak lr).
REHEARSE_SERVE, REHEARSE_TRAIN = (8, 64, 6), (4, 256, 2, 2, 3e-4)
# chip_smoke.py's phase 12 at smoke width (bf16): phase 9's rehearsal's
# request (rows, prompt, generated tokens), 2 rows a rank on (2, 1, 2).
REHEARSE_EP_POD = (4, 64, 6)

# The reference's tasks run in JAX_PARTS subprocesses, each every
# JAX_PARTS-th task (one process took 80 s).
JAX_PARTS = 4
JAX_REF = """
import dataclasses, math, os
# LLVM at -O0 compiles the reference's steps in two thirds of the time; XLA's
# HLO passes, which decide the sums' order, run as they do by default.
os.environ['XLA_FLAGS'] += ' --xla_backend_optimization_level=0'
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.configs import RunConfig, ShapeConfig, get_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_decode_step, build_prefill_step, build_train_step, init_train_state
from repro.models import Model, input_specs

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

def podded(init, run):
    # The reference's npods=2 layout of one init: a pod dim on every leaf in
    # local mode, ef zeros under int8 sync.
    state = jax.tree.map(lambda x: np.broadcast_to(x, (2,) + np.shape(x)).copy(), init) \\
        if run.sync_mode == 'local' else dict(init)
    if run.compress_int8:
        state['ef'] = jax.tree.map(lambda x: np.zeros((2,) + x.shape, np.float32), init['params'])
    return state

def served(model, params, prompts, mesh, tag):
    # serve()'s loop: greedy tokens from the prefill and decode steps, and
    # the prefill's and the first decode step's last-token logits.
    cfg = model.cfg
    bs, plen, glen = SERVE['batch'], SERVE['prompt_len'], SERVE['gen_len']
    pshape = ShapeConfig('serve', plen, bs, 'prefill')
    prefill, _, (param_sh, pbatch_sh, _) = build_prefill_step(model, mesh, pshape, plen + glen)
    params = jax.device_put(params, param_sh)
    logits, caches = prefill(params, jax.device_put(prompts, pbatch_sh))
    res[f'{tag}/prefill'] = np.asarray(logits[:, -1])
    dec, _, _ = build_decode_step(model, mesh, ShapeConfig('serve', plen + glen, bs, 'decode'), plen + glen)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    gen = [np.asarray(tok)]
    for i in range(glen - 1):
        logits, caches = dec(params, caches, tok)
        if i == 0:
            res[f'{tag}/decode'] = np.asarray(logits[:, -1])
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gen.append(np.asarray(tok))
    res[f'{tag}/tokens'] = np.concatenate(gen, axis=1)

res, inits = {}, {}

def init(arch):
    # JAX's jitted init, once for each arch this process steps or serves.
    if arch not in inits:
        model = Model(get_config(arch, smoke=True).with_overrides(dtype='float32'))
        state = jax.device_get(jax.jit(lambda key: init_train_state(model, RunConfig(total_steps=10), key))(jax.random.PRNGKey(0)))
        if arch.startswith('deepseek'):
            state['params'] = conditioned(state['params'])
        inits[arch] = state
    return inits[arch]

def stepped(tag, arch, shape, kw, moe):
    cfg = get_config(arch, smoke=True).with_overrides(dtype='float32')
    if moe:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe))
    run = RunConfig(total_steps=10, **{**RUN, **kw})
    model = Model(cfg)
    mesh = make_mesh(shape, ('pod', 'data', 'model'))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (STEPS, B, T + 1))
    with set_mesh(mesh):
        step, _, state_sh, batch_sh = build_train_step(model, run, mesh, ShapeConfig('t', T, B, 'train'))
        state = jax.device_put(podded(init(arch), run), state_sh)
        for i in range(STEPS):
            batch = {'tokens': toks[i, :, :-1].astype(np.int32), 'labels': toks[i, :, 1:].astype(np.int32)}
            state, m = step(state, jax.device_put(batch, batch_sh))
            for key in ('loss', 'grad_norm'):
                res.setdefault(f'{tag}/{key}', []).append(float(m[key]))
    for group in ('params', 'ef'):
        if group in state:
            for k, v in flat(jax.device_get(state[group])).items():
                res[f'{tag}/{group}/{k}'] = v

def serve_llama():
    cfg = get_config(LLAMA, smoke=True).with_overrides(dtype='float32')
    mesh = make_mesh((2, 1, 2), ('pod', 'data', 'model'))
    pshape = ShapeConfig('serve', SERVE['prompt_len'], SERVE['batch'], 'prefill')
    with set_mesh(mesh):
        served(Model(cfg), init(LLAMA)['params'], input_specs(cfg, pshape, concrete=True, rng=jax.random.PRNGKey(1)), mesh, 'serve')

def serve_moe():
    # deepseek-v2 served on (2, 2, 1) at capacity factor 0.5: its prefill's
    # one group spans the 4 row ranks, 1 row each.
    cfg = get_config(MOE, smoke=True).with_overrides(dtype='float32')
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **DROP))
    mesh = make_mesh((2, 2, 1), ('pod', 'data', 'model'))
    prompts = {'tokens': np.random.default_rng(3).integers(0, cfg.vocab_size, (SERVE['batch'], SERVE['prompt_len'])).astype(np.int32)}
    with set_mesh(mesh):
        served(Model(cfg), init(MOE)['params'], prompts, mesh, 'moe-serve')

# This subprocess's share: every PARTS-th task from PART.
TASKS = [lambda t=t: stepped(*t) for t in TAGS] + [serve_llama, serve_moe]
for task in TASKS[PART::PARTS]:
    task()
np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
print('OK ref')
"""


def _conditioned(params):
    """deepseek's MLA up-projections rescaled to 1/sqrt(rank), as the JAX
    script's ``conditioned`` does (port keys)."""
    return {k: v * math.sqrt(v.shape[-2] / v.shape[-3])
            if k.rsplit(".", 1)[-1] in ("w_uq", "w_uk", "w_uv") else v
            for k, v in params.items()}


def _params(arch):
    """JAX's initial parameters of ``arch`` (smoke, fp32), drawn from
    ``PRNGKey(0)`` by the jitted ``init_train_state`` that the subprocess
    runs too (port keys, numpy)."""
    model = JaxModel(jax_config(arch, smoke=True).with_overrides(dtype="float32"))
    init = jax.jit(lambda key: jax_train_state(model, JaxRunConfig(total_steps=10), key))(
        jax.random.PRNGKey(0))
    params = {k: v.numpy() for k, v in params_from_jax(jax.device_get(init["params"])).items()}
    return _conditioned(params) if arch == MOE else params


def _prompts():
    cfg = jax_config(LLAMA, smoke=True).with_overrides(dtype="float32")
    pshape = JaxShapeConfig("serve", SERVE["prompt_len"], SERVE["batch"], "prefill")
    return {k: np.asarray(v) for k, v in jax_input_specs(
        cfg, pshape, concrete=True, rng=jax.random.PRNGKey(1)).items()}


def _moe_prompts():
    vocab = get_config(MOE, smoke=True).vocab_size
    return {"tokens": np.random.default_rng(3).integers(
        0, vocab, (SERVE["batch"], SERVE["prompt_len"]))}


def _batches(arch):
    vocab = get_config(arch, smoke=True).vocab_size
    return np.random.default_rng(7).integers(0, vocab, (STEPS, B, T + 1))


def _tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, started first; then, from JAX's initial
    parameters, the port's 4-rank spawn of the held runs and, beside it, the
    4-rank rehearsal of phase 11; meanwhile, in this process, the
    rehearsal's one-rank references."""
    out = tmp_path_factory.mktemp("jax_ref")
    head = (f"TAGS, RUN, SERVE, LLAMA, MOE, DROP = {TAGS!r}, {RUN!r}, {SERVE!r}, {LLAMA!r}, "
            f"{MOE!r}, {DROP!r}\nSTEPS, B, T = {STEPS}, {B}, {T}\n")
    jax_parts = {f"jax {i}": lambda i=i: run_multidevice(
        head + f"OUT, PART, PARTS = {str(out / f'ref{i}.npz')!r}, {i}, {JAX_PARTS}\n" + JAX_REF,
        devices=4, timeout=600) for i in range(JAX_PARTS)}
    ckpt, cli = (str(tmp_path_factory.mktemp(n)) for n in ("ckpt_local", "ckpt_cli"))
    ckpt_kw = dict(**RUN, **MODES["local"], total_steps=3, checkpoint_every=2,
                   checkpoint_dir=ckpt)
    cs = torch_rank_fns._chip_smoke()
    rows, seq, micro, steps, lr = REHEARSE_TRAIN
    params = {}

    def held():
        params.update({LLAMA: _params(LLAMA), MOE: _params(MOE)})
        runs = lambda modes: [{**RUN, **MODES[m]} for m in modes]
        flat = lambda tag, fn="step_modes": (fn, (MOE, FLAT_MOE[tag][0], params[MOE],
                                                 _batches(MOE), runs(["flat"]), AXES,
                                                 FLAT_MOE[tag][1]))
        jobs = [("step_modes", (LLAMA, (2, 1, 2), params[LLAMA], _batches(LLAMA),
                                runs(MODES), AXES)),
                ("block_scaled_steps", (LLAMA, (2, 1, 2), params[LLAMA], _batches(LLAMA),
                                        runs(["int8"]), AXES)),
                ("step_modes", (LLAMA, (2, 2, 1), params[LLAMA], _batches(LLAMA),
                                runs(D2_MODES), AXES)),
                ("step_modes", (MOE, (2, 1, 2), params[MOE], _batches(MOE), runs(["sync"]),
                                AXES)),
                ("pod_serve", (LLAMA, (2, 1, 2), params[LLAMA], _prompts(), *SERVE.values())),
                ("train_fp32", (LLAMA, (2, 1, 2), 3, ckpt_kw, False, AXES)),
                ("train_fp32", (LLAMA, (2, 2, 1), 3, ckpt_kw, True, AXES)),
                ("cli_main", (["--arch", LLAMA, "--steps", "1", "--seq-len", "16", "--batch",
                               "8", "--ckpt-dir", cli, "--mesh-shape", "2,1,2", "--mesh-axes",
                               "pod,data,model", "--sync-mode", "sync", "--device", "cpu"],)),
                ("step_modes", (MOE, (2, 2, 1), params[MOE], _batches(MOE), runs(["sync"]),
                                AXES)),
                ("pod_serve", (MOE, (2, 1, 2), params[MOE], _moe_prompts(), *SERVE.values())),
                flat("moe-flat-a2a"), flat("moe-flat-d2"), flat("moe-flat-g2"),
                flat("moe-flat-d2", "pod_alone_steps"),
                ("tp_logits", (MOE, (2, 2, 1), params[MOE], _moe_prompts(),
                               SERVE["prompt_len"] + SERVE["gen_len"], DROP, None, None, AXES)),
                ("pod_serve", (MOE, (2, 2, 1), params[MOE], _moe_prompts(), *SERVE.values(),
                               AXES, DROP))]
        return spawn_ranks(torch_rank_fns.ranks_main, 4, (jobs,), timeout=600)

    def refs():
        refs = _rehearsal_refs(cs)
        refs["moe_tokens"] = torch_rank_fns.pod_serve(
            MOE, (1, 1), _params(MOE), _moe_prompts(), *SERVE.values(),
            axes=torch_rank_fns.DATA_MODEL)[0]
        return refs

    parts = torch_rank_fns.side_by_side({
        **jax_parts, "rehearsal": lambda: spawn_ranks(
            torch_rank_fns.chip_smoke_pods_rank, 4,
            ((LLAMA, *REHEARSE_SERVE), (LLAMA, rows, seq, micro, steps, lr), REHEARSE_EP_POD,
             True, "cpu"), timeout=600),
        "held": held, "refs": refs})
    ref = {}
    for i in range(JAX_PARTS):
        assert "OK ref" in parts[f"jax {i}"]
        with np.load(out / f"ref{i}.npz") as f:
            ref.update({k: f[k] for k in f.files})
    return {"jax": ref, "ranks": parts["held"], "rehearsal": parts["rehearsal"],
            "refs": parts["refs"], "params": params, "ckpt": ckpt_kw, "cli": cli}


def _rehearsal_refs(cs):
    """One rank's references of phases 11 and 12 at smoke width (bf16): the
    prefill's last-token logits and the served tokens (phase 4's), step 1's
    loss and grad-norm (phase 8's one rank), and phase 12's
    (``ep_serve_reference`` with pods 2)."""
    batch, plen, glen = REHEARSE_SERVE
    cfg = get_config(LLAMA, smoke=True)
    model = Model(cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(0))
    prompts = input_specs(cfg, ShapeConfig("serve", plen, batch, "prefill"),
                          generator=torch.Generator("cpu").manual_seed(1), device="cpu")
    logits = model.prefill(prompts, plen + glen)[0][:, -1].float().numpy()
    tokens = serve(LLAMA, batch=batch, prompt_len=plen, gen_len=glen, device="cpu")["tokens"]
    rows, seq, micro, _, lr = REHEARSE_TRAIN
    first = cs.one_rank_step(LLAMA, {}, rows, seq, micro, lr, 0, True, "cpu")
    ep_pod = cs.ep_serve_reference(REHEARSE_EP_POD, cs.EP_POD_MESH[0][0], True, "cpu", True)
    return {"logits": logits, "tokens": tokens.numpy(), "first": first, "ep_pod": ep_pod}


def _job(runs, i):
    """Every rank's result of job ``i`` of the held spawn."""
    return [rank[i] for rank in runs["ranks"]]


def _outside(got, want):
    return np.abs(got - want) > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want)


def _int8_flips(res, ref, tag, pod):
    """``tests/test_torch_multipod_train.py``'s int8 rule: the ef and
    parameter elements outside GRAD_TOL, each ef element at most one
    quantisation level off (2.02 max |ef| of its leaf) and each parameter at
    most 2 lr (one per step) off.  Returns (ef flips, parameter flips,
    elements, whether every element kept within its level)."""
    lr, flips, total, within = RUN["learning_rate"], [0, 0], 0, True
    for key, got in res["ef"].items():
        want = ref[f"{tag}/ef/{key}"][pod]
        p, w = res["params"][key], ref[f"{tag}/params/{key}"]
        off, p_off = _outside(got, want), _outside(p, w)
        within &= bool(np.all(np.abs(got - want)[off] <= 2.02 * np.abs(want).max()))
        within &= bool(np.all(np.abs(p - w)[p_off] <= 2 * lr))
        flips[0] += int(off.sum())
        flips[1] += int(p_off.sum())
        total += off.size
    return (*flips, total, within)


@pytest.mark.parametrize("tag", ["flat", "sync", "local", "sync-d2"])
def test_pod_modes_on_sharded_meshes_match_jax(runs, tag):
    """Each rank's losses, grad-norms and its pod's parameters, gathered
    whole over (data, model), against JAX's on the same mesh (local: its
    own pod's, the pods parted after step 1 and met after step 2)."""
    i, mode = (2, tag[:-3]) if tag.endswith("-d2") else (0, tag)
    modes = D2_MODES if i == 2 else list(MODES)
    ref = runs["jax"]
    for rank in _job(runs, i):
        res = rank["runs"][list(modes).index(mode)]
        np.testing.assert_allclose(res["loss"], ref[f"{tag}/loss"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], ref[f"{tag}/grad_norm"], rtol=1e-5)
        want = _tree(ref, f"{tag}/params/")
        assert set(res["params"]) == set(want)
        for key, w in want.items():
            w = w[rank["coords"]["pod"]] if w.shape != res["params"][key].shape else w
            np.testing.assert_allclose(res["params"][key], w, err_msg=f"{tag} {key}", **GRAD_TOL)


@pytest.mark.parametrize("tag", ["int8", "int8-d2"])
def test_int8_sync_on_sharded_meshes_matches_jax(runs, tag):
    """int8 sync on (2, 1, 2) and (2, 2, 1): losses, grad-norms, parameters
    and each pod's ef against JAX's, by the multi-pod test's int8 rule
    (fp32 order can flip a quantisation level: elements outside GRAD_TOL
    under 1 in 2000, within a level).  On (2, 1, 2) a planted quantiser with
    a scale per block rather than per leaf must break that rule."""
    i = 2 if tag.endswith("-d2") else 0
    modes = D2_MODES if i == 2 else list(MODES)
    ref = runs["jax"]
    for rank in _job(runs, i):
        res, pod = rank["runs"][modes.index("int8")], rank["coords"]["pod"]
        np.testing.assert_allclose(res["loss"], ref[f"{tag}/loss"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], ref[f"{tag}/grad_norm"], rtol=1e-5)
        ef, par, total, within = _int8_flips(res, ref, tag, pod)
        print(f"{tag}, pod {pod}: elements outside GRAD_TOL, ef {ef} and parameters {par} "
              f"of {total}")
        assert within and max(ef, par) < total / 2000, (ef, par, total)
    if i == 0:
        for rank in _job(runs, 1):
            ef, par, total, within = _int8_flips(rank["runs"][0], ref, tag, rank["coords"]["pod"])
            assert not within or max(ef, par) >= total / 2000, (ef, par, total)


def test_pod_bytes_are_the_ranks_blocks(runs):
    """Over pods each rank sends only its own blocks, about half of a whole
    replica's elements on both meshes: flat's and sync's pod bytes a step
    are asymmetry's all-reduce of the rank's elements in fp32, int8's the
    all-gather of its int8 block and of the leaves' scales, local's the
    grad-norm's mean and, at the budget's step, the parameter blocks'."""
    from repro_torch.core.asymmetry import all_gather_wire_bytes, allreduce_wire_bytes

    whole = sum(v.size for v in runs["params"][LLAMA].values())
    for i, modes in ((0, list(MODES)), (2, list(D2_MODES))):
        # On (2, 1, 2) the rows' group is the pod group: the two metrics'
        # mean (ce and loss) goes over it too.
        metrics = allreduce_wire_bytes(4 * 2, 2) if i == 0 else 0.0
        for rank in _job(runs, i):
            for mode, res in zip(modes, rank["runs"]):
                n, leaves = res["n_rank"], res["n_leaves"]
                assert 0.45 * whole < n < 0.55 * whole, (n, whole)
                want = {"flat": [allreduce_wire_bytes(4 * n, 2)] * STEPS,
                        "sync": [allreduce_wire_bytes(4 * n, 2)] * STEPS,
                        "int8": [all_gather_wire_bytes(2 * n, 2)
                                 + all_gather_wire_bytes(2 * 4 * leaves, 2)] * STEPS,
                        "local": [allreduce_wire_bytes(4, 2), allreduce_wire_bytes(4, 2)
                                  + allreduce_wire_bytes(4 * n, 2)]}[mode]
                assert [w["pod"] - metrics for w in res["wire"]] == want, (mode, i)


def _moe_rule(runs, res, tag):
    """What breaks ``tests/test_torch_multipod_train.py``'s MoE rule for one
    rank's run ``res`` against JAX's ``tag`` (losses and grad-norms within
    rtol 1e-5; parameter elements outside GRAD_TOL under 1 in 10^4 and
    within lr / 2: AdamW turns near-zero gradients' fp32 noise into updates
    near lr); empty where it holds."""
    ref, lr, broken = runs["jax"], RUN["learning_rate"], []
    for key in ("loss", "grad_norm"):
        if not np.allclose(res[key], ref[f"{tag}/{key}"], rtol=1e-5, atol=0):
            broken.append(f"{key} {res[key]} against {ref[f'{tag}/{key}'].tolist()}")
    want = _tree(ref, f"{tag}/params/")
    assert set(res["params"]) == set(want)
    off = total = 0
    for key, got in res["params"].items():
        outside = _outside(got, want[key])
        if not np.all(np.abs(got - want[key])[outside] <= lr / 2):
            broken.append(f"{key} off by more than lr / 2")
        off += int(outside.sum())
        total += got.size
    if off >= total / 10 ** 4:
        broken.append(f"{off} of {total} elements outside GRAD_TOL")
    return broken


@pytest.mark.parametrize("tag, job", [("moe", 3), ("moe-d2", 8)])
def test_moe_sync_over_sharded_pods_matches_jax(runs, tag, job):
    """deepseek-v2 in sync on (2, 1, 2), each pod's rows routed on its model
    ranks, and on (2, 2, 1), each pod's rows routed over its two data ranks
    as the reference's vmap over pods routes them; losses, grad-norms and
    parameters by the MoE rule (:func:`_moe_rule`)."""
    for rank in _job(runs, job):
        assert not _moe_rule(runs, rank["runs"][0], tag), rank["coords"]


@pytest.mark.parametrize("tag, job", [("moe-flat-a2a", 10), ("moe-flat-d2", 11),
                                      ("moe-flat-g2", 12)])
def test_flat_moe_over_pods_matches_jax(runs, tag, job):
    """deepseek-v2 in flat over pods at capacity factor 0.5, against JAX's
    ``build_train_step`` in flat (its groups over the ``(pod, data)`` rows,
    ``_gf_axes``): the island on (2, 1, 2) (capacity per source slice, the
    EP group inside a pod), and on (2, 2, 1) one group over the 4 row ranks
    and 2 groups over 2 each; by the MoE rule (:func:`_moe_rule`)."""
    for rank in _job(runs, job):
        assert not _moe_rule(runs, rank["runs"][0], tag), rank["coords"]


def test_a_group_over_one_pod_breaks_flat_moe(runs):
    """The planted fault (``chip_smoke.py``'s ``pod_alone_rows``): flat on
    (2, 2, 1) with each pod's rows routed alone, the route before flat MoE
    over pods was ported: at capacity factor 0.5 it breaks the MoE rule
    against JAX's flat step on every rank."""
    for rank in _job(runs, 13):
        assert _moe_rule(runs, rank["runs"][0], "moe-flat-d2"), rank["coords"]


def test_moe_serves_on_sharded_pods_as_on_one_rank(runs):
    """serve() of deepseek-v2 (fp32) on (2, 1, 2): each rank's prefill held
    its ``(pod, data)`` rows, batch / 2, its group spanning both pods' rows,
    and every rank's tokens are the port's one-rank tokens."""
    for tokens, rows in _job(runs, 9):
        np.testing.assert_array_equal(tokens, runs["refs"]["moe_tokens"])
        assert rows == [SERVE["batch"] // 2]


def test_moe_served_on_pod_data_rows_matches_jax(runs):
    """deepseek-v2 served on (2, 2, 1) at capacity factor 0.5, each rank its
    ``(pod, data)`` row (batch / 4), the prefill's one group spanning the 4
    row ranks: each rank's prefill and first decode step's last-token
    logits, and serve()'s tokens, against JAX's prefill, decode and serving
    loop on the same mesh."""
    ref = runs["jax"]
    for res in _job(runs, 14):
        i = res["coords"]["pod"] * 2 + res["coords"]["data"]
        for what in ("prefill", "decode"):
            np.testing.assert_allclose(res[what], ref[f"moe-serve/{what}"][i:i + 1], **GRAD_TOL)
    for tokens, rows in _job(runs, 15):
        np.testing.assert_array_equal(tokens, ref["moe-serve/tokens"])
        assert rows == [SERVE["batch"] // 4]


def test_serve_on_pods_matches_jax_and_splits_the_rows(runs):
    """serve() on (2, 1, 2): every rank's tokens JAX's on the same mesh, and
    each rank's prefill held its pod's batch / P rows, not the whole batch."""
    for tokens, rows in _job(runs, 4):
        np.testing.assert_array_equal(tokens, runs["jax"]["serve/tokens"])
        assert rows == [SERVE["batch"] // 2]


def test_local_checkpoint_loads_in_jax_and_resumes_on_other_meshes(runs):
    """train() in local mode on (2, 1, 2) wrote a checkpoint at step 2: it
    loads under JAX's train_state_specs(npods=2) (a pod dim on every leaf,
    the step count [2, 2], each pod's own moments); train() on (2, 2, 1)
    resumes it through step 3 as the uninterrupted (2, 1, 2) run's step 3
    (fp32 order: rtol 1e-5); and on one rank, each pod's slice restored and
    stepped on its pod's rows gives that step's loss and grad-norm as their
    mean over pods (the reference's local metrics)."""
    kw = runs["ckpt"]
    run = JaxRunConfig(**{k: v for k, v in kw.items() if k != "checkpoint_dir"})
    shapes, _ = train_state_specs(JaxModel(jax_config(LLAMA, smoke=True).with_overrides(
        dtype="float32")), run, npods=2)
    state, step, _ = jax_load_checkpoint(kw["checkpoint_dir"], shapes, step=2)
    assert step == 2
    state = jax.device_get(state)
    np.testing.assert_array_equal(np.asarray(state["opt"]["step"]), [2, 2])
    pods = [train_state_from_jax(state, pod=p) for p in (0, 1)]
    want = {k: v.shape for k, v in Model(get_config(LLAMA, smoke=True), device="cpu")
            .state_dict().items()}
    for pod in pods:
        assert {k: t.shape for k, t in pod["params"].items()} == want
    assert any(not torch.equal(pods[0]["opt"]["mu"][k], pods[1]["opt"]["mu"][k])
               for k in want)
    whole, resumed = _job(runs, 5), _job(runs, 6)
    for a, b in zip(whole, resumed):
        assert [h["step"] for h in a] == [1, 2, 3] and [h["step"] for h in b] == [3]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(b[0][key], a[2][key], rtol=1e-5, err_msg=key)
    # One rank: each pod's state, stepped on its pod's rows of step 3's batch.
    cfg = torch_rank_fns._fp32(LLAMA)
    run = RunConfig(**kw)
    data = SyntheticLMDataset(cfg, ShapeConfig("t", T, B, "train"), seed=run.seed)
    it = make_batch_iterator(data, start_step=2)
    batch = {k: torch.from_numpy(v).long() for k, v in next(it).items()}
    it.close()
    got = []
    for p, pod in enumerate(pods):
        model = Model(cfg, device="cpu")
        state1 = init_train_state(model, run)
        restore_train_state(state1, pod)
        mesh = Mesh(axes=("pod",), shape={"pod": 2}, coords={"pod": p}, device=model.device)
        rows = rank_rows(batch, mesh, "local", run.microbatches)
        _, m = build_train_step(model, run)(state1, rows)
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(np.mean(got, axis=0),
                               [whole[0][2]["loss"], whole[0][2]["grad_norm"]], rtol=1e-5)


def test_cli_trains_on_a_pod_data_model_mesh(runs):
    """The CLI under a 4-rank process group with --mesh-shape 2,1,2
    --mesh-axes pod,data,model --sync-mode sync runs with no refusal; its
    checkpoint holds whole tensors with no pod dim, as JAX's
    train_state_specs(npods=2) lays out sync without int8."""
    run = JaxRunConfig(sync_mode="sync", total_steps=1)
    shapes, _ = train_state_specs(JaxModel(jax_config(LLAMA, smoke=True)), run, npods=2)
    state, step, _ = jax_load_checkpoint(runs["cli"], shapes, step=1)
    assert step == 1 and "ef" not in state
    got = train_state_from_jax(jax.device_get(state))
    assert int(got["opt"]["step"]) == 1
    want = {k: v.shape for k, v in Model(get_config(LLAMA, smoke=True), device="cpu")
            .state_dict().items()}
    assert {k: t.shape for k, t in got["params"].items()} == want


def test_two_axis_groups_on_a_three_axis_mesh():
    """The groups of (2, 2, 2), from the mesh's shape alone: one per axis,
    the pod's own ranks (data+model) and the rows (pod+data), each joining
    the ranks that share every other coordinate; on (2, 1, 2) a pair spans
    one axis and needs no group.  Phase 11's planted fault pairs each pod
    group across model ranks, which the members show."""
    sizes = dict(zip(AXES, (2, 2, 2)))
    assert group_spans(sizes) == {"pod": ("pod",), "data": ("data",), "model": ("model",),
                                  "data+model": ("data", "model"),
                                  "pod+data": ("pod", "data"), "world": AXES}
    assert group_ranks(sizes, ("pod",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert group_ranks(sizes, ("data", "model")) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert group_ranks(sizes, ("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    mesh = Mesh(axes=AXES, shape=sizes, coords={"pod": 1, "data": 0, "model": 1},
                device=torch.device("cpu"))
    assert [mesh.group_name(a) for a in (("data", "model"), ("pod", "data"), ("pod",),
                                         AXES, ("model", "data"))] == [
        "data+model", "pod+data", "pod", "world", "data+model"]
    assert mesh.group_size("data+model") == 4 and mesh.group_size("pod+data") == 4
    with pytest.raises(ValueError, match="no group spans"):
        mesh.group_name(("pod", "model"))
    small = dict(zip(AXES, (2, 1, 2)))
    assert set(group_spans(small)) == {"pod", "model", "world"}
    # A pod group's ranks share their model coordinate, r % 2 on (2, 1, 2).
    same = lambda groups: all(len({r % 2 for r in g}) == 1 for g in groups)
    assert same(group_ranks(small, ("pod",)))
    from repro_torch.launch import mesh as mesh_mod

    with torch_rank_fns._chip_smoke().crossed_pod_group():
        crossed = mesh_mod.group_ranks(small, ("pod",))
    assert crossed == [[0, 3], [1, 2]] and not same(crossed)


def test_phase_11_rehearses_at_smoke_width_on_the_cpu(runs):
    """chip_smoke.py's phase 11 at smoke width (bf16) on 4 CPU ranks: its
    serving and training checks pass (the planted pod group across model
    ranks among them: the pods' blocks part after step 1 and step 2's loss
    leaves sync's); they fail when a prefill holds the whole batch, a step
    counts other bytes, the local pods do not part, or the fault's run
    reads as sound sync's."""
    cs = torch_rank_fns._chip_smoke()
    ref, cfg = runs["refs"], get_config(LLAMA, smoke=True)
    batch, plen, _ = REHEARSE_SERVE
    serving = [r["serve"] for r in runs["rehearsal"]]
    assert cs.check_pod_tp_serving(serving, cfg, batch, plen, ref["logits"], ref["tokens"],
                                   None) <= cs.TP_LOGITS_RTOL
    whole = copy.deepcopy(serving)
    whole[3]["prefill_rows"] = batch
    with pytest.raises(AssertionError, match="share"):
        cs.check_pod_tp_serving(whole, cfg, batch, plen, ref["logits"], ref["tokens"], None)
    training = [r["train"] for r in runs["rehearsal"]]
    real = cs.POD_TP_TRAIN
    cs.POD_TP_TRAIN = (LLAMA, *REHEARSE_TRAIN)
    try:
        losses = cs.check_pod_tp_training(training, cfg, ref["first"], None, None)
        assert all(math.isfinite(x) for v in losses.values() for x in v)
        modes = [rec["mode"] for rec in training[0]]
        extra = copy.deepcopy(training)
        extra[2][modes.index("sync")]["history"][1]["wire_bytes"]["pod"] += 4
        with pytest.raises(AssertionError, match="wire bytes"):
            cs.check_pod_tp_training(extra, cfg, ref["first"], None, None)
        stuck = copy.deepcopy(training)
        local = modes.index("local")
        for r in (2, 3):  # pod 1's ranks take pod 0's blocks after step 1
            stuck[r][local]["steps"][0]["digest"] = stuck[r - 2][local]["steps"][0]["digest"]
        with pytest.raises(AssertionError, match="blocks equal"):
            cs.check_pod_tp_training(stuck, cfg, ref["first"], None, None)
        blind = copy.deepcopy(training)
        fault, sync = modes.index(cs.POD_TP_FAULT[0]), modes.index("sync")
        for rank in blind:
            rank[fault]["steps"] = rank[sync]["steps"]
            rank[fault]["history"] = rank[sync]["history"]
        with pytest.raises(AssertionError, match="cannot tell"):
            cs.check_pod_tp_training(blind, cfg, ref["first"], None, None)
    finally:
        cs.POD_TP_TRAIN = real


def test_phase_12_rehearses_at_smoke_width_on_the_cpu(runs):
    """chip_smoke.py's phase 12 at smoke width (bf16) on 4 CPU ranks
    (deepseek-v2 served on (2, 1, 2), 2 rows a rank): its checks pass
    (logits and tokens against one rank's, bytes, decode's slot offsets on
    pod 1 equal to pod 0's counts, the planted route of each pod alone
    failing that probe); they fail when a prefill holds the whole batch, a
    decode step counts 4 bytes more, or pod 1's offsets read as the fault's."""
    cs = torch_rank_fns._chip_smoke()
    ref, cfg = runs["refs"]["ep_pod"], cs.ep_config(smoke=True)
    batch, plen, _ = REHEARSE_EP_POD
    ranks = [r["eppod"] for r in runs["rehearsal"]]
    assert cs.check_ep_pod_serving(ranks, cfg, batch, plen, ref, None) <= cs.EP_LOGITS_RTOL
    whole = copy.deepcopy(ranks)
    whole[2]["prefill_rows"] = batch
    with pytest.raises(AssertionError, match="share"):
        cs.check_ep_pod_serving(whole, cfg, batch, plen, ref, None)
    extra = copy.deepcopy(ranks)
    extra[1]["decode_bytes"][0]["pod"] += 4
    with pytest.raises(AssertionError, match="decode wire bytes"):
        cs.check_ep_pod_serving(extra, cfg, batch, plen, ref, None)
    alone = copy.deepcopy(ranks)
    for r in alone:
        r["offsets"] = r["fault_offsets"]
    with pytest.raises(AssertionError, match="does not span the pods' rows"):
        cs.check_ep_pod_serving(alone, cfg, batch, plen, ref, None)
