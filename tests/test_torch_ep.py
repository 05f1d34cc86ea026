"""Expert parallelism over gloo ranks against the JAX package's all-to-all
island (``expert_sharding="ep_a2a"``, ``repro/models/moe.py::_manual_ep_moe``).

JAX runs in four subprocesses with four host devices each (``conftest``'s
``run_multidevice``), its cases split over them and run in threads:
deepseek-v2 smoke on ``ep_a2a`` at (data 1, model 2) and (2, 2), deepseek-v3 smoke with 256 experts at (2, 2)
(the island's 2-D branch: experts on ``(data, model)`` jointly, the
all-to-all over both axes), each two steps of ``build_train_step`` (two
microbatches) and the logits of ``build_prefill_step`` and of one
``build_decode_step`` (T 1: the island's fallback, the scatter path over
ranks; at (2, 2) deepseek-v2's one group spans both data ranks and
deepseek-v3's two groups lie one on each, its experts gathered over
``data``), then greedy decoding to the served tokens at (1, 2); and one step
of deepseek-v2 at T 128 with capacity factor 0.5, where choices drop.
Beside it the port runs on 4 gloo ranks in one spawn and on 2 in another,
from the same initial parameters, each rank its blocks of them.

All in fp32, within ``GRAD_TOL``.  The parameters are JAX's draws with the
MLA up-projections rescaled to their contraction's fan-in (see
``tests/test_torch_moe_train.py``'s ``conditioned``), and the learning rate
is 1e-4 (1e-5 for the one-step drop case), where an AdamW step of an
element whose gradient is near AdamW's eps cannot turn a 1e-7 relative
gradient difference into a parameter difference past the tolerance."""

import dataclasses
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

import torch_rank_fns  # noqa: E402
from conftest import run_multidevice  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
V2, V3 = "deepseek-v2-236b", "deepseek-v3-671b"
SERVE = (4, 8, 4)  # batch, prompt, generated tokens
EP = {"expert_sharding": "ep_a2a"}
CASES = [
    dict(name="v2_12", arch=V2, mesh=(1, 2), moe=EP, B=8, T=16, steps=2, micro=2, lr=1e-4,
         serve=SERVE),
    dict(name="v2_22", arch=V2, mesh=(2, 2), moe=EP, B=8, T=16, steps=2, micro=2, lr=1e-4,
         serve=SERVE),
    dict(name="v3_22", arch=V3, mesh=(2, 2), moe=dict(EP, num_experts=256, groups=2), B=8,
         T=16, steps=2, micro=2, lr=1e-4, serve=SERVE),
    dict(name="drop", arch=V2, mesh=(1, 2), moe=dict(EP, capacity_factor=0.5), B=2, T=128,
         steps=1, micro=1, lr=1e-5),
]
BY_NAME = {c["name"]: c for c in CASES}

JAX_REF = """
import dataclasses, math, os
from concurrent.futures import ThreadPoolExecutor
# LLVM at O1 compiles the reference's steps in about 70 % of the time of its
# default O2, and its code keeps the port as near: an element whose gradient
# sits near AdamW's eps read at most 0.70 of GRAD_TOL at O1 and 0.75 at O2
# (mla_12 of tests/test_torch_moe_mesh.py), 0.99 at O0.
os.environ['XLA_FLAGS'] += ' --xla_backend_optimization_level=1'
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.configs import RunConfig, ShapeConfig, get_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_decode_step, build_prefill_step, build_train_step, init_train_state
from repro.models import Model, input_specs

UP = ('w_uq', 'w_uk', 'w_uv')

def conditioned(tree):
    if isinstance(tree, dict):
        return {k: (v * math.sqrt(v.shape[-2] / v.shape[-3]) if k in UP else conditioned(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [conditioned(v) for v in tree]
    return tree

def flat(tree, prefix=''):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f'{prefix}.{k}' if prefix else str(k)
        out.update(flat(v, key) if isinstance(v, (dict, list, tuple)) else {key: np.asarray(v)})
    return out

def one(c, part):
    cfg = get_config(c['arch'], smoke=True).with_overrides(dtype='float32')
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **c['moe']))
    mesh = make_mesh(c['mesh'], ('data', 'model'), devices=jax.devices()[:math.prod(c['mesh'])])
    model = Model(cfg)
    B, T, n = c['B'], c['T'], c['name']
    res = {}
    with set_mesh(mesh):
        if part == 'train':
            run = RunConfig(total_steps=10, learning_rate=c['lr'], warmup_steps=0, microbatches=c['micro'])
            toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (c['steps'], B, T + 1))
            step, _, state_sh, batch_sh = build_train_step(model, run, mesh, ShapeConfig('t', T, B, 'train'))
            state = init_train_state(model, run, jax.random.PRNGKey(0))
            state = jax.device_put(dict(state, params=conditioned(state['params'])), state_sh)
            for i in range(c['steps']):
                batch = {'tokens': toks[i, :, :-1].astype(np.int32), 'labels': toks[i, :, 1:].astype(np.int32)}
                state, m = step(state, jax.device_put(batch, batch_sh))
                for key in ('loss', 'grad_norm'):
                    res.setdefault(f'{n}/{key}', []).append(float(m[key]))
            for k, v in flat(jax.device_get(state['params'])).items():
                res[f'{n}/params/{k}'] = v
            return res
        bs, plen, glen = c['serve']
        pshape = ShapeConfig('serve', plen, bs, 'prefill')
        prefill, _, (param_sh, pbatch_sh, _) = build_prefill_step(model, mesh, pshape, plen + glen)
        decode, _, _ = build_decode_step(model, mesh, ShapeConfig('serve', plen + glen, bs, 'decode'), plen + glen)
        params = jax.device_put(conditioned(model.init(jax.random.PRNGKey(0))), param_sh)
        prompts = input_specs(cfg, pshape, concrete=True, rng=jax.random.PRNGKey(1))
        logits, caches = prefill(params, jax.device_put(prompts, pbatch_sh))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        res[f'{n}/prefill'], tokens = np.asarray(logits[:, -1]), [np.asarray(tok)]
        for i in range(glen - 1):
            logits, caches = decode(params, caches, tok)
            if i == 0:
                res[f'{n}/decode'] = np.asarray(logits[:, -1])
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            tokens.append(np.asarray(tok))
        res[f'{n}/tokens'] = np.concatenate(tokens, axis=1)
    return res

# This subprocess's share: every PARTS-th task from PART, the steps first.
TASKS = ([(c, 'train') for c in CASES] + [(c, 'serve') for c in CASES if c.get('serve')])[PART::PARTS]
with ThreadPoolExecutor(len(TASKS)) as pool:
    res = {k: v for r in pool.map(lambda t: one(*t), TASKS) for k, v in r.items()}
np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
print('OK ref')
"""


def conditioned(tree):
    """JAX's parameter tree with each MLA up-projection ``[..., rank, heads,
    d]`` scaled by sqrt(heads / rank) (``tests/test_torch_moe_train.py``)."""
    if isinstance(tree, dict):
        return {k: (v * math.sqrt(v.shape[-2] / v.shape[-3]) if k in ("w_uq", "w_uk", "w_uv")
                    else conditioned(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [conditioned(v) for v in tree]
    return tree


_INITS, _INIT_LOCK = {}, threading.Lock()


def _params(c):
    """The case's config and initial parameters (numpy, ``state_dict``
    keys): JAX's draws from ``PRNGKey(0)``, conditioned.  Drawn once for
    each arch and expert count (the other MoE fields change no draw), one
    draw at a time: the fixtures' threads ask for them together, and the
    first draw compiles JAX's random ops under the interpreter lock."""
    cfg = jax_config(c["arch"], smoke=True).with_overrides(dtype="float32")
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **c["moe"]))
    key = (c["arch"], cfg.moe.num_experts)
    with _INIT_LOCK:
        if key not in _INITS:
            tree = conditioned(jax.device_get(JaxModel(cfg).init(jax.random.PRNGKey(0))))
            _INITS[key] = {k: v.numpy() for k, v in params_from_jax(tree).items()}
    return cfg, _INITS[key]


def jax_parts(cases, out_dir, n=4):
    """``torch_rank_fns.side_by_side`` parts that run :data:`JAX_REF` over
    ``cases`` in ``n`` subprocesses of four host devices, each every n-th
    task (a process's threads trace under one interpreter lock, so one
    process took 1.6 times as long), each writing ``ref{i}.npz`` under
    ``out_dir``."""
    return {f"jax {i}": lambda i=i: run_multidevice(
        f"CASES, OUT, PART, PARTS = {cases!r}, {str(out_dir / f'ref{i}.npz')!r}, {i}, {n}\n"
        + JAX_REF, devices=4, timeout=600) for i in range(n)}


def jax_results(parts, out_dir):
    """The JAX results of :func:`jax_parts`' ``parts``, merged."""
    ref = {}
    for i, name in enumerate(n for n in parts if n.startswith("jax")):
        assert "OK ref" in parts[name]
        with np.load(out_dir / f"ref{i}.npz") as f:
            ref.update({k: f[k] for k in f.files})
    return ref


def _jobs(c):
    """The rank jobs of case ``c``: its steps; with ``serve`` the prefill and
    decode logits and, at (1, 2), ``serve()``'s tokens."""
    cfg, params = _params(c)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (c["steps"], c["B"], c["T"] + 1))
    run = dict(learning_rate=c["lr"], warmup_steps=0, microbatches=c["micro"])
    jobs = [("tp_steps", (c["arch"], c["mesh"], params, toks, run, c["moe"]))]
    if c.get("serve"):
        bs, plen, glen = c["serve"]
        prompts = {k: np.asarray(v) for k, v in jax_input_specs(
            cfg, JaxShapeConfig("serve", plen, bs, "prefill"), concrete=True,
            rng=jax.random.PRNGKey(1)).items()}
        jobs.append(("tp_logits", (c["arch"], c["mesh"], params, prompts, plen + glen, c["moe"])))
        if c["mesh"] == (1, 2):
            jobs.append(("tp_serve", (c["arch"], c["mesh"], params, prompts, bs, plen, glen,
                                      c["moe"])))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocesses, the 4-rank spawn and the 2-rank spawn side by
    side (``torch_rank_fns.side_by_side``: each part's time is printed, and
    a part that fails is reported with the others' times); each rank's
    results by case name."""
    out = tmp_path_factory.mktemp("jax_ep")
    by_size = {2: [c for c in CASES if c["mesh"] == (1, 2)],
               4: [c for c in CASES if c["mesh"] == (2, 2)]}
    spawn = lambda n: spawn_ranks(torch_rank_fns.ranks_main, n,
                                  ([j for c in by_size[n] for j in _jobs(c)],), timeout=600)
    parts = torch_rank_fns.side_by_side({
        **jax_parts(CASES, out), **{f"{n} ranks": lambda n=n: spawn(n) for n in by_size}})
    ranks = {n: parts[f"{n} ranks"] for n in by_size}
    ref = jax_results(parts, out)
    port = {}
    for n, cases in by_size.items():
        for rank in ranks[n]:
            results = iter(rank)
            for c in cases:
                got = port.setdefault(c["name"], [])
                got.append({"steps": next(results)})
                if c.get("serve"):
                    got[-1]["logits"] = next(results)
                    if c["mesh"] == (1, 2):
                        got[-1]["tokens"] = next(results)
    return {"jax": ref, "port": port}


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_island_steps_as_jax(runs, name):
    """Every rank's losses and grad-norms, and the final parameters gathered
    whole, against JAX's ``ep_a2a`` train step; the island's exchange puts
    bytes on ``model`` (and, for 256 experts, on the (data, model) group,
    ``world``)."""
    ref = runs["jax"]
    want = {k[len(name) + 8:]: v for k, v in ref.items() if k.startswith(f"{name}/params/")}
    for rank in runs["port"][name]:
        res = rank["steps"]
        np.testing.assert_allclose(res["loss"], ref[f"{name}/loss"], **GRAD_TOL)
        np.testing.assert_allclose(res["grad_norm"], ref[f"{name}/grad_norm"], **GRAD_TOL)
        assert set(res["params"]) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(res["params"][key], w, err_msg=f"{res['coords']} {key}",
                                       **GRAD_TOL)
        assert all(w.get("model", 0) > 0 for w in res["wire"])
        if name == "v3_22":
            # The 2-D exchange is the largest thing on the world group.
            assert all(w["world"] > w["model"] for w in res["wire"])


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c.get("serve")])
def test_prefill_and_decode_logits_match_jax(runs, name):
    """Each rank's rows' last-token logits over the whole vocab: the prefill
    on the island, one decode step on the fallback."""
    ref, c = runs["jax"], BY_NAME[name]
    rows = c["serve"][0] // c["mesh"][0]
    for rank in runs["port"][name]:
        res = rank["logits"]
        sl = slice(res["coords"]["data"] * rows, (res["coords"]["data"] + 1) * rows)
        np.testing.assert_allclose(res["prefill"], ref[f"{name}/prefill"][sl], **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], ref[f"{name}/decode"][sl], **GRAD_TOL)


def test_serve_gives_jax_tokens(runs):
    """``serve(mesh_shape=(1, 2))`` of deepseek-v2 on ``ep_a2a`` from JAX's
    weights and prompts: both ranks return JAX's greedy tokens."""
    for rank in runs["port"]["v2_12"]:
        np.testing.assert_array_equal(rank["tokens"], runs["jax"]["v2_12/tokens"])
        assert rank["tokens"].shape == (SERVE[0], SERVE[2])


def test_choices_drop_on_both_ranks(runs):
    """At T 128 and capacity factor 0.5 each model rank's slice drops choices
    in every island call (the forward and remat's recompute of both MoE
    layers), on both sides of the exchange; the losses above agree with
    JAX's, so the same choices dropped."""
    ranks = runs["port"]["drop"]
    assert len(ranks) == 2
    for rank in ranks:
        drops = rank["steps"]["drops"]
        assert len(drops) == 4 and all(d > 0 for d in drops), drops
    # The two slices route different tokens.
    assert ranks[0]["steps"]["drops"] != ranks[1]["steps"]["drops"]
    assert math.isfinite(ranks[0]["steps"]["loss"][0])
