"""MoE on meshes whose counts do not divide, against the JAX package:
routing groups that straddle data ranks, experts that do not divide over
their ranks (``fit_pspec`` leaves ``wi`` and ``wo`` whole: every model rank
runs every expert) and an ``fsdp_f`` FFN dim that does not divide over
``data``.

Smoke deepseek-v2 in fp32 at capacity factor 0.5, where choices drop, so
that a wrong slot offset shows.  JAX runs in two subprocesses of six host
devices (LLVM at O1, as ``tests/test_torch_ep.py``'s ``JAX_REF``), their
tasks in threads: each case's two steps of ``build_train_step`` (loss, grad-norm,
the load-balance ``aux``, the final parameters) and the first batch's
``jax.grad`` on one device.  Beside it the port runs each mesh in a gloo
spawn of its own, from the same initial parameters, at lr 1e-4 (an
unmoved leaf would pass the parameter check: the gradients are held too).

| case | layout | mesh | held to |
|---|---|---|---|
| ``straddle_31`` | ``fsdp_d``, 4 groups over 3 data ranks | (3, 1) | JAX's GSPMD |
| ``fsdpf_31`` | ``fsdp_f``, FFN dim 32 over data 3 | (3, 1) | JAX's GSPMD |
| ``ep2d_13`` | ``ep2d``, 8 experts over 3 ranks | (1, 3) | JAX's GSPMD |
| ``experts6_14`` | ``fsdp_d``, 6 experts over model 4 | (1, 4) | JAX's GSPMD |
| ``ep2d_32`` | ``ep2d``, 8 experts, 4 groups; served too | (3, 2) | JAX on one device |

On (3, 2) with groups that straddle data ranks the reference's GSPMD step
parts from its own one-device step (a fault of the reference: ROADMAP's
Queue 3); its reading is printed beside the one-device one.  Last, both
packages raise for the expert-parallel island on (1, 3), where 8 experts do
not divide over model 3."""

import copy
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn_ranks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

import torch_rank_fns  # noqa: E402
from conftest import run_multidevice  # noqa: E402
from test_torch_ep import JAX_REF, _params  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
V2 = "deepseek-v2-236b"
DROP = {"capacity_factor": 0.5}
CASES = [
    dict(name="straddle_31", mesh=(3, 1), moe=dict(DROP, expert_sharding="fsdp_d", groups=4),
         B=6, T=16),
    dict(name="fsdpf_31", mesh=(3, 1), moe=dict(DROP, expert_sharding="fsdp_f"), B=6, T=16),
    dict(name="ep2d_13", mesh=(1, 3), moe=dict(DROP, expert_sharding="ep2d"), B=3, T=15),
    dict(name="experts6_14", mesh=(1, 4), moe=dict(DROP, expert_sharding="fsdp_d",
                                                   num_experts=6), B=4, T=16, lr=1e-5),
    dict(name="ep2d_32", mesh=(3, 2), moe=dict(DROP, expert_sharding="ep2d", groups=4), B=6,
         T=16, one=True, serve=(6, 8, 2)),
]
# lr 1e-4; 1e-5 for experts6_14, where after two AdamW steps one element of
# lead.0.attn.w_dq whose gradient sits near AdamW's eps read 2.5e-5 from
# GSPMD's (the gradients agree within GRAD_TOL: the update's division by
# sqrt(v) amplifies their last bits), as tests/test_torch_tp_uneven.py found.
for _c in CASES:
    _c.update({"arch": V2, "steps": 2, "micro": 1, "lr": 1e-4, **_c})
BY_NAME = {c["name"]: c for c in CASES}
# chip_smoke.py's phase 15 at smoke width (bf16) on the 3-rank spawn: rows,
# prompt, generated tokens (3 x 64 tokens in 16 groups of 12: each rank's 64
# straddle them; decode's 3 tokens are one group over the three ranks).
REHEARSE = (3, 64, 2)
# JAX's subprocesses, each every JAX_PARTS-th task: one process's threads
# trace under one interpreter lock (one process took 63 s, two 49-51 s each
# beside the spawns, on 8 cores).
JAX_PARTS = 2
# The island where the reference's shard_map raises: 8 experts over model 3.
ISLAND = dict(name="island_13", arch=V2, mesh=(1, 3), moe={"expert_sharding": "ep_a2a"}, B=3,
              T=15)

# The reference's functions (JAX_REF's imports, ``conditioned``, ``flat`` and
# ``one``), then this file's tasks: each case's steps on its mesh (and, for a
# case held to one device, on (1, 1) too), the first batch's gradient on one
# device, the served case's logits on one device, and the island's error.
JAX_CODE = JAX_REF.split("# This subprocess's share")[0] + """
def steps(c, shape, tag):
    cfg = get_config(c['arch'], smoke=True).with_overrides(dtype='float32')
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **c['moe']))
    mesh = make_mesh(shape, ('data', 'model'), devices=jax.devices()[:math.prod(shape)])
    model, res, B, T = Model(cfg), {}, c['B'], c['T']
    with set_mesh(mesh):
        run = RunConfig(total_steps=10, learning_rate=c['lr'], warmup_steps=0, microbatches=c['micro'])
        toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (c['steps'], B, T + 1))
        step, _, state_sh, batch_sh = build_train_step(model, run, mesh, ShapeConfig('t', T, B, 'train'))
        state = init_train_state(model, run, jax.random.PRNGKey(0))
        state = jax.device_put(dict(state, params=conditioned(state['params'])), state_sh)
        for i in range(c['steps']):
            batch = {'tokens': toks[i, :, :-1].astype(np.int32), 'labels': toks[i, :, 1:].astype(np.int32)}
            state, m = step(state, jax.device_put(batch, batch_sh))
            for key in ('loss', 'grad_norm', 'aux'):
                res.setdefault(f'{tag}/{key}', []).append(float(m[key]))
        if tag == c['name']:
            for k, v in flat(jax.device_get(state['params'])).items():
                res[f'{tag}/params/{k}'] = v
    return res

def grads(c):
    cfg = get_config(c['arch'], smoke=True).with_overrides(dtype='float32')
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **c['moe']))
    model = Model(cfg)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (c['steps'], c['B'], c['T'] + 1))
    batch = {'tokens': jnp.asarray(toks[0, :, :-1], jnp.int32), 'labels': jnp.asarray(toks[0, :, 1:], jnp.int32)}
    with set_mesh(make_mesh((1, 1), ('data', 'model'), devices=jax.devices()[:1])):
        params = conditioned(model.init(jax.random.PRNGKey(0)))
        g = jax.jit(jax.grad(lambda p: model.loss(p, batch)[0]))(params)
    return {f"{c['name']}/grads/{k}": v for k, v in flat(jax.device_get(g)).items()}

def island(c):
    try:
        steps(dict(c, steps=1, lr=1e-4, micro=1), c['mesh'], c['name'])
    except Exception as e:
        return {f"{c['name']}/error": np.asarray(f'{type(e).__name__}: {e}')}
    return {f"{c['name']}/error": np.asarray('')}

TASKS = ([lambda c=c: steps(c, (1, 1) if c.get('one') else c['mesh'], c['name']) for c in CASES]
         + [lambda c=c: steps(c, c['mesh'], c['name'] + '@gspmd') for c in CASES if c.get('one')]
         + [lambda c=c: grads(c) for c in CASES]
         + [lambda c=dict(c, mesh=(1, 1)): one(c, 'serve') for c in CASES if c.get('serve')]
         + [lambda: island(ISLAND)])[PART::PARTS]
with ThreadPoolExecutor(len(TASKS)) as pool:
    res = {k: v for r in pool.map(lambda t: t(), TASKS) for k, v in r.items()}
np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
print('OK ref')
"""


def _batches(c, vocab):
    return np.random.default_rng(7).integers(0, vocab, (c["steps"], c["B"], c["T"] + 1))


def _jobs(c):
    cfg, params = _params(c)
    run = dict(learning_rate=c["lr"], warmup_steps=0, microbatches=c["micro"])
    jobs = [("tp_steps", (c["arch"], c["mesh"], params, _batches(c, cfg.vocab_size), run,
                          c["moe"], None, True))]
    if c.get("serve"):
        bs, plen, glen = c["serve"]
        prompts = {k: np.asarray(v) for k, v in jax_input_specs(
            cfg, JaxShapeConfig("serve", plen, bs, "prefill"), concrete=True,
            rng=jax.random.PRNGKey(1)).items()}
        jobs.append(("tp_logits", (c["arch"], c["mesh"], params, prompts, plen + glen,
                                   c["moe"])))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocesses, one spawn per mesh size (the 3-rank one also
    rehearses chip_smoke.py's phase 15) and phase 15's one-rank reference
    side by side (``torch_rank_fns.side_by_side``); each rank's results by
    case name."""
    cs = torch_rank_fns._chip_smoke()
    out = tmp_path_factory.mktemp("jax_moe_uneven")
    by_size = {}
    for c in CASES:
        by_size.setdefault(math.prod(c["mesh"]), []).append(c)
    rehearse = [("chip_smoke_uneven_ep_rank", (*REHEARSE, True, "cpu", True))]
    spawn = lambda n: spawn_ranks(torch_rank_fns.ranks_main, n, (
        [j for c in by_size[n] for j in _jobs(c)] + (rehearse if n == 3 else []),), timeout=600)
    jax_part = lambda i: run_multidevice(
        f"CASES, ISLAND, OUT, PART, PARTS = {CASES!r}, {ISLAND!r}, "
        f"{str(out / f'ref{i}.npz')!r}, {i}, {JAX_PARTS}\n" + JAX_CODE, devices=6, timeout=600)
    parts = torch_rank_fns.side_by_side({
        **{f"jax {i}": lambda i=i: jax_part(i) for i in range(JAX_PARTS)},
        **{f"{n} ranks": lambda n=n: spawn(n) for n in by_size},
        "reference": lambda: cs.ep_serve_reference(REHEARSE, 1, True, "cpu", True,
                                                   cs.uneven_ep_config(smoke=True))})
    ref = {}
    for i in range(JAX_PARTS):
        assert "OK ref" in parts[f"jax {i}"]
        with np.load(out / f"ref{i}.npz") as f:
            ref.update({k: f[k] for k in f.files})
    port, rehearsal = {}, []
    for n, cases in by_size.items():
        for rank in parts[f"{n} ranks"]:
            results = iter(rank)
            for c in cases:
                got = port.setdefault(c["name"], [])
                got.append({"steps": next(results)})
                if c.get("serve"):
                    got[-1]["logits"] = next(results)
            if n == 3:
                rehearsal.append(next(results))
    return {"jax": ref, "port": port, "cs": cs, "rehearsal": rehearsal,
            "reference": parts["reference"]}


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_steps_and_first_gradients_match_jax(runs, name):
    """Every rank's losses, grad-norms and load-balance losses of two steps,
    the final parameters gathered whole, and every leaf's gradient of the
    first batch against the reference (its GSPMD step, or its one-device
    step where GSPMD parts from it); choices drop on some rank in some MoE
    call, and each leaf whole on ``model`` is equal on every model rank."""
    ref, c = runs["jax"], BY_NAME[name]
    if c.get("one"):
        gspmd = {k: ref[f"{name}@gspmd/{k}"].tolist() for k in ("loss", "grad_norm", "aux")}
        print(f"[{name}] one device: loss {ref[f'{name}/loss'].tolist()}, aux "
              f"{ref[f'{name}/aux'].tolist()}; the reference's GSPMD step on {c['mesh']}: "
              f"{gspmd}")
    want = {k[len(name) + 8:]: v for k, v in ref.items() if k.startswith(f"{name}/params/")}
    want_g = {k[len(name) + 7:]: v for k, v in ref.items() if k.startswith(f"{name}/grads/")}
    ranks = [r["steps"] for r in runs["port"][name]]
    assert len(ranks) == math.prod(c["mesh"])
    assert sum(sum(r["drops"]) for r in ranks) > 0
    for res in ranks:
        for key in ("loss", "grad_norm", "aux"):
            np.testing.assert_allclose(res[key], ref[f"{name}/{key}"], err_msg=key, **GRAD_TOL)
        assert set(res["params"]) == set(want) == set(want_g) == set(res["grads"])
        for key, w in want_g.items():
            np.testing.assert_allclose(res["grads"][key], w, err_msg=f"{res['coords']} {key}",
                                       **GRAD_TOL)
        for key, w in want.items():
            np.testing.assert_allclose(res["params"][key], w, err_msg=f"{res['coords']} {key}",
                                       **GRAD_TOL)
    for res in ranks:
        same = next(r for r in ranks if r["coords"]["data"] == res["coords"]["data"])
        for key in res["whole_on_model"]:
            np.testing.assert_array_equal(res["params"][key], same["params"][key], err_msg=key)
            np.testing.assert_array_equal(res["grads"][key], same["grads"][key], err_msg=key)


def test_served_on_3_by_2_matches_one_device(runs):
    """``ep2d_32`` served: each rank's rows' last-token logits of a prefill
    (4 groups of 12 tokens over the data ranks' 16) and of one decode step
    (one group over all three) against the reference's on one device."""
    ref, c = runs["jax"], BY_NAME["ep2d_32"]
    rows = c["serve"][0] // c["mesh"][0]
    for rank in runs["port"]["ep2d_32"]:
        res = rank["logits"]
        sl = slice(res["coords"]["data"] * rows, (res["coords"]["data"] + 1) * rows)
        np.testing.assert_allclose(res["prefill"], ref["ep2d_32/prefill"][sl], **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], ref["ep2d_32/decode"][sl], **GRAD_TOL)


def test_both_packages_refuse_the_island_where_its_experts_do_not_divide(runs):
    """``ep_a2a`` on (1, 3): the reference's ``shard_map`` raises on ``wi``
    (8 experts over model 3), and the port raises in its MoE call, naming
    the limit; decode (T 1 is no multiple of model 3) takes the scatter path
    and runs."""
    assert "not evenly divisible" in str(runs["jax"][f"{ISLAND['name']}/error"])
    cfg = get_config(V2, smoke=True).with_overrides(dtype="float32")
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **ISLAND["moe"]))
    p = Model(cfg, device="cpu").blocks.layer(0)["b0"]["ffn"]
    mesh = Mesh(axes=("data", "model"), shape={"data": 1, "model": 3},
                coords={"data": 0, "model": 0}, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="8 experts over model 3 do not divide"):
        moe_mod.moe_ffn(p, torch.zeros(1, 15, cfg.d_model), cfg, mesh, moe_mod.Rows(mesh))
    one = torch_rank_fns.threaded_ranks((1, 3), lambda m: moe_mod.moe_ffn(
        p, torch.ones(1, 1, cfg.d_model), cfg, m, moe_mod.Rows(m))[0])
    want, _ = moe_mod.moe_ffn(p, torch.ones(1, 1, cfg.d_model), cfg)
    for y in one:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_phase_15_rehearses_at_smoke_width_on_the_cpu(runs):
    """chip_smoke.py's phase 15 at smoke width (bf16) on 3 CPU ranks
    (deepseek-v2 on ep2d, 16 groups, served on (3, 1), one row a rank): its
    checks pass (logits and first tokens against one rank's, every expert
    on every rank, each group's bytes, the slot offsets of every MoE call
    equal to the counts of the pieces before them, the planted fault of each
    rank's own counts failing that probe); they fail when a prefill holds
    the whole batch, a decode step counts 4 bytes more, a rank holds fewer
    experts, or the offsets read as the fault's."""
    cs, ref, ranks = runs["cs"], runs["reference"], runs["rehearsal"]
    cfg = cs.uneven_ep_config(smoke=True)
    batch, plen, _ = REHEARSE
    assert cs.check_uneven_ep_serving(ranks, cfg, batch, plen, ref, None) <= cs.EP_LOGITS_RTOL
    for change, match in (
            (lambda r: r[2].update(prefill_rows=batch), "share"),
            (lambda r: r[1]["decode_bytes"][0].update(
                world=r[1]["decode_bytes"][0]["world"] + 4), "decode wire bytes"),
            (lambda r: r[0].update(experts=cfg.moe.num_experts - 1), "of the"),
            (lambda r: [x.update(offsets=x["fault_offsets"]) for x in r],
             "does not straddle the ranks")):
        bad = copy.deepcopy(ranks)
        change(bad)
        with pytest.raises(AssertionError, match=match):
            cs.check_uneven_ep_serving(bad, cfg, batch, plen, ref, None)
