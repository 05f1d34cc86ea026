"""Tensor parallelism on widths that do not divide over ``model``, placed as
the reference's ``fit_pspec`` places them, over 8 gloo ranks against the
JAX package's GSPMD on 8 host devices.

JAX runs once, in one subprocess with 8 host devices (``conftest``'s
``run_multidevice``), in fp32 from ``PRNGKey(0)``, on a (1, 8) mesh: smoke
xlstm-1.3b as it is (4 mLSTM heads over 8 ranks, as on the production
meshes; three steps of ``build_train_step``, the prefill's and a decode
step's logits and the greedy tokens of those steps), and one step, the
prefill's and a decode step's logits of four more: smoke llama3.2-1b, whose
4 query heads do not divide over 8 but their ``H·hd`` columns do (and its
KV heads' columns); smoke recurrentgemma-9b cut to its one (rec, rec,
attn) super-block, with an RG-LRU width of 60 and a ``d_ff`` of 90 (both
blocks whole) and heads of 12 (the query heads gathered, the one KV head's
12 columns whole); llama with 8 query heads of 12 over one KV head (the
query heads split, the KV head's count and columns whole) and a ``d_ff`` of
100 (swiglu's ``wi`` split contiguously, ``wo`` whole); smoke
deepseek-v2-236b, whose 4 MLA heads (the up-projections whole, ``wo``
split on its rows) and one shared expert of width 12 (``wi`` split
contiguously, ``wo`` whole) do not divide over 8.  For every case JAX also
takes ``jax.grad`` of the loss at the initial weights on the first batch.
The port runs on 8 gloo ranks in one spawn from the same parameters (the
MLA up-projections conditioned as in ``tests/test_torch_ep.py``), and each
case is held to JAX within ``tests/test_torch_tp_recurrent.py``'s
tolerance: the steps, the parameters after them, the logits and the first
gradient of every leaf; each leaf whole on ``model`` is equal on every rank,
its gradient and its value after the steps.  The planted fault
(``chip_smoke.py::plain_column_cut``: the mLSTM's whole cell output cut to
the rank's columns by a plain slice) must miss JAX's gradient of ``wq``.
``chip_smoke.py``'s phase 14 is rehearsed at smoke width."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import init_train_state as train_state  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import gqa_layout  # noqa: E402

import torch_rank_fns  # noqa: E402
from conftest import run_multidevice  # noqa: E402
from test_torch_ep import conditioned  # noqa: E402

XL, LLAMA, RG, DS = "xlstm-1.3b", "llama3.2-1b", "recurrentgemma-9b", "deepseek-v2-236b"
M = 8
MESH = (1, M)
B, T = 8, 16
# lr 1e-5, where tests/test_torch_tp_recurrent.py takes 1e-4: AdamW's first
# steps move an element by about lr times the sign of its gradient, and fp32
# summation order flips the sign of gradients near zero.  At 1e-4 JAX's own
# three steps of smoke xlstm-1.3b on 1 and on 8 host devices put one element
# of blocks.b0.cell.w_if 1.77e-5 apart (the port's 8 ranks 1.99e-5 from JAX's
# 8 devices), over GRAD_TOL there; every gradient of the port's 8 ranks lay
# within 4e-6 of its largest element from one process's.
RUN = dict(learning_rate=1e-5, warmup_steps=0, microbatches=1)
SERVE = dict(batch=4, prompt_len=8, gen_len=4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_tp_recurrent.py's
PROBE = "blocks.b0.cell.wq"
# (name, arch, config fields (a dict replaces a sub-config's fields), steps,
# served, the attention's layout on model 8)
CASES = [
    ("xlstm", XL, {}, 3, True, None),
    ("llama-heads", LLAMA, {}, 1, False, "gathered"),
    ("rg-width", RG, {"rglru": {"width": 60}, "d_ff": 90, "head_dim": 12, "num_layers": 3},
     1, False, "gathered"),
    ("llama-kv-dff", LLAMA, {"num_heads": 8, "head_dim": 12, "num_kv_heads": 1, "d_ff": 100},
     1, False, "kv_whole"),
    # one shared expert of d 12: its swiglu wi (2 x 12 columns) splits
    # contiguously over 8 and its wo stays whole
    ("ds-mla", DS, {"moe": {"num_shared": 1, "d_expert": 12}}, 1, False, None),
]
NAMES = [c[0] for c in CASES]
# chip_smoke.py's phase 14 at smoke width in fp32 on (1, 8): served (arch,
# config fields, rows, prompt, generated tokens, fault), trained (arch,
# config fields, rows, tokens per row, microbatches, steps, lr, warmup) and
# the probe (arch, layers, tokens, key).
REHEARSE_MESH = ((1, M), ("data", "model"))
FP32 = {"dtype": "float32"}
REHEARSE_SERVE = ((XL, FP32, 2, 16, 2, None),)
REHEARSE_TRAIN = ((XL, FP32, 2, 16, 1, 1, 1e-3, 0),)
REHEARSE_PROBE = (XL, None, 16, PROBE)

JAX_REF = """
import dataclasses, os
# LLVM at -O0 compiles the steps in three quarters of the time (as in
# tests/test_torch_pod_shard.py).
os.environ['XLA_FLAGS'] += ' --xla_backend_optimization_level=0'
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.configs import RunConfig, ShapeConfig, get_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_decode_step, build_prefill_step, build_train_step, init_train_state
from repro.models import Model, input_specs

def configured(arch, over):
    cfg = get_config(arch, smoke=True)
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
          for k, v in over.items()}
    return cfg.with_overrides(dtype='float32', **kw)

def conditioned(tree):
    if isinstance(tree, dict):
        return {k: (v * np.sqrt(v.shape[-2] / v.shape[-3]) if k in ('w_uq', 'w_uk', 'w_uv')
                    else conditioned(v)) for k, v in tree.items()}
    return [conditioned(v) for v in tree] if isinstance(tree, list) else tree

def flat(tree, prefix=''):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f'{prefix}.{k}' if prefix else str(k)
        out.update(flat(v, key) if isinstance(v, (dict, list, tuple)) else {key: np.asarray(v)})
    return out

res = {}
mesh = make_mesh((1, M), ('data', 'model'))
for name, arch, over, steps, served, _ in CASES:
    cfg = configured(arch, over)
    model = Model(cfg)
    run = RunConfig(total_steps=10, **RUN)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (steps, B, T + 1))
    init = jax.device_get(jax.jit(lambda key: init_train_state(model, run, key))(jax.random.PRNGKey(0)))
    init['params'] = conditioned(init['params'])
    with set_mesh(mesh):
        step, _, state_sh, batch_sh = build_train_step(model, run, mesh, ShapeConfig('t', T, B, 'train'))
        first = {'tokens': toks[0, :, :-1].astype(np.int32), 'labels': toks[0, :, 1:].astype(np.int32)}
        g = jax.jit(jax.grad(lambda p: model.loss(p, first)[0]))(init['params'])
        for k, v in flat(jax.device_get(g)).items():
            res[f'{name}/grad/{k}'] = v
        state = jax.device_put(init, state_sh)
        for i in range(steps):
            batch = {'tokens': toks[i, :, :-1].astype(np.int32), 'labels': toks[i, :, 1:].astype(np.int32)}
            state, m = step(state, jax.device_put(batch, batch_sh))
            for key in ('loss', 'grad_norm'):
                res.setdefault(f'{name}/{key}', []).append(float(m[key]))
        for k, v in flat(jax.device_get(state['params'])).items():
            res[f'{name}/params/{k}'] = v
        bs, plen, glen = SERVE['batch'], SERVE['prompt_len'], SERVE['gen_len']
        pshape = ShapeConfig('serve', plen, bs, 'prefill')
        prefill, _, (param_sh, pbatch_sh, _) = build_prefill_step(model, mesh, pshape, plen + glen)
        params = jax.device_put(init['params'], param_sh)
        prompts = input_specs(cfg, pshape, concrete=True, rng=jax.random.PRNGKey(1))
        logits, caches = prefill(params, jax.device_put(prompts, pbatch_sh))
        res[f'{name}/prefill'] = np.asarray(logits[:, -1])
        dec, _, _ = build_decode_step(model, mesh, ShapeConfig('serve', plen + glen, bs, 'decode'), plen + glen)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gen = [np.asarray(tok)]
        for i in range(glen - 1 if served else 1):
            logits, caches = dec(params, caches, tok)
            res.setdefault(f'{name}/decode', np.asarray(logits[:, -1]))
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            gen.append(np.asarray(tok))
        if served:
            res[f'{name}/tokens'] = np.concatenate(gen, axis=1)
np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
print('OK ref')
"""


def _jax_cfg(arch, over):
    import dataclasses

    cfg = jax_config(arch, smoke=True)
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
          for k, v in over.items()}
    return cfg.with_overrides(dtype="float32", **kw)


def _params(arch, over):
    """JAX's initial parameters of the case, drawn from ``PRNGKey(0)`` by the
    jitted ``init_train_state`` that its subprocess runs too, the MLA
    up-projections conditioned as there."""
    model = JaxModel(_jax_cfg(arch, over))
    run = JaxRunConfig(total_steps=10, **RUN)
    init = jax.jit(lambda key: train_state(model, run, key))(jax.random.PRNGKey(0))
    tree = conditioned(jax.device_get(init["params"]))
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _prompts(arch, over):
    pshape = JaxShapeConfig("serve", SERVE["prompt_len"], SERVE["batch"], "prefill")
    return {k: np.asarray(v) for k, v in jax_input_specs(
        _jax_cfg(arch, over), pshape, concrete=True, rng=jax.random.PRNGKey(1)).items()}


def _batches(arch, over, steps):
    vocab = torch_rank_fns._fp32(arch, over=over).vocab_size
    return np.random.default_rng(7).integers(0, vocab, (steps, B, T + 1))


def _one_process(arch, over, params, prompts, max_len):
    """The case's prefill and decode logits in the port's one process, from
    the whole ``params``."""
    model = Model(torch_rank_fns._fp32(arch, over=over), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    logits, caches = model.prefill({k: torch.from_numpy(v).long() for k, v in prompts.items()},
                                   max_len)
    step, _ = model.decode_step(caches, logits[:, -1].argmax(-1, keepdim=True))
    return {"prefill": logits[:, -1].numpy(), "decode": step[:, -1].numpy()}


def _rehearsal_refs(cs):
    """One rank's references of phase 14 at smoke width: the served
    config's prefill logits, the trained config's step 1 (loss, grad-norm)
    and the probe's whole fp32 gradient."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import input_specs

    (arch, over, batch, plen, glen, _), = REHEARSE_SERVE
    cfg = get_config(arch, smoke=True).with_overrides(**over)
    model = Model(cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(0))
    prompts = input_specs(cfg, ShapeConfig("serve", plen, batch, "prefill"),
                          generator=torch.Generator("cpu").manual_seed(1), device="cpu")
    logits = model.prefill(prompts, plen + glen)[0][:, -1].float().numpy()
    (arch, over, rows, seq, micro, _, lr, warmup), = REHEARSE_TRAIN
    first = cs.one_rank_step(arch, over, rows, seq, micro, lr, warmup, True, "cpu")
    probe = cs.grad_probe(*REHEARSE_PROBE, smoke=True, device="cpu", fault=None)["sound"]
    return {"logits": logits, "first": first, "probe": probe}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, started first; then, from JAX's initial
    parameters, the one 8-rank spawn beside it.  ``ranks``: each rank's
    results by job ``(case, kind)``."""
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    head = (f"CASES, RUN, SERVE, PROBE = {CASES!r}, {RUN!r}, {SERVE!r}, {PROBE!r}\n"
            f"M, B, T, OUT = {M}, {B}, {T}, {str(out)!r}\n")
    with ThreadPoolExecutor(len(CASES) + 1) as pool:
        jax_run = pool.submit(run_multidevice, head + JAX_REF, devices=M, timeout=600)
        params = dict(zip(NAMES, pool.map(lambda c: _params(*c[1:3]), CASES)))
        prompts = {name: _prompts(arch, over) for name, arch, over, *_ in CASES}
        max_len = SERVE["prompt_len"] + SERVE["gen_len"]
        jobs = {}
        for name, arch, over, steps, served, _ in CASES:
            batches = _batches(arch, over, steps)
            jobs[name, "steps"] = ("tp_steps", (arch, MESH, params[name], batches, RUN, None,
                                                over))
            jobs[name, "logits"] = ("tp_logits", (arch, MESH, params[name], prompts[name],
                                                  max_len, None, over))
            jobs[name, "grads"] = ("tp_grads", (arch, MESH, params[name], batches[0], None,
                                                over))
            if served:
                jobs[name, "serve"] = ("tp_serve", (arch, MESH, params[name], prompts[name],
                                                    *SERVE.values()))
        jobs["xlstm", "fault"] = ("tp_grads", (XL, MESH, params["xlstm"], _batches(XL, {}, 1)[0],
                                               [PROBE], None, "plain_column_cut"))
        jobs["rehearsal", "ranks"] = ("chip_smoke_tp_recurrent_rank", (
            REHEARSE_SERVE, REHEARSE_TRAIN, REHEARSE_PROBE, True, "cpu", REHEARSE_MESH,
            "plain_column_cut"))
        spawned = pool.submit(spawn_ranks, torch_rank_fns.ranks_main, M, (list(jobs.values()),),
                              timeout=600)
        _, arch, over, *_ = CASES[NAMES.index("ds-mla")]
        ds_one = _one_process(arch, over, params["ds-mla"], prompts["ds-mla"], max_len)
        rehearsal = _rehearsal_refs(torch_rank_fns._chip_smoke())
        ranks = [dict(zip(jobs, rank)) for rank in spawned.result()]
        assert "OK ref" in jax_run.result()
    with np.load(out) as f:
        ref = {k: f[k] for k in f.files}
    return {"jax": ref, "ranks": ranks, "ds": ds_one, "rehearsal": rehearsal}


def _job(runs, name, kind):
    """Each rank's result of job ``kind`` of case ``name``."""
    return [rank[name, kind] for rank in runs["ranks"]]


def _whole_on_model(name):
    """The case's leaves that ``param_layout`` keeps whole on ``model``."""
    _, arch, over, *_ = next(c for c in CASES if c[0] == name)
    from repro_torch.launch.mesh import meta_mesh

    model = Model(torch_rank_fns._fp32(arch, over=over), mesh=meta_mesh(MESH, ("data", "model")))
    return [k for k, pl in model.layout.items() if pl.dim_of("model") is None]


@pytest.mark.parametrize("name", NAMES)
def test_layouts_leave_the_width_whole_as_fit_pspec_does(name):
    """Each case's layout on model 8: the attention's (``gqa_layout``) and
    the widths that ``param_layout`` keeps whole, which is what the case is
    there to exercise; nothing is refused."""
    _, arch, over, _, _, attn = next(c for c in CASES if c[0] == name)
    cfg = torch_rank_fns._fp32(arch, over=over)
    from repro_torch.launch.mesh import meta_mesh

    model = Model(cfg, mesh=meta_mesh((1, M), ("data", "model")))
    split = {k for k, pl in model.layout.items() if pl.dim_of("model") is not None}
    if attn is not None:
        assert gqa_layout(cfg, M) == attn
    if name == "xlstm":  # the heads' weights whole, the inner width split
        assert not {"blocks.b0.cell.wq", "blocks.b0.cell.wk", "blocks.b0.cell.wv"} & split
        assert {"blocks.b0.cell.w_up", "blocks.b0.cell.w_if", "blocks.b0.cell.w_down"} <= split
    if name == "rg-width":  # the RG-LRU block and the FFN whole, wq split, wk whole
        assert not {k for k in split if ".rec." in k or ".ffn." in k}
        assert "blocks.b2.attn.wq" in split and "blocks.b2.attn.wk" not in split
    if name == "llama-kv-dff":  # wk whole; wi split contiguously, wo whole
        assert "blocks.b0.attn.wq" in split and "blocks.b0.attn.wk" not in split
        assert model.layout["blocks.b0.ffn.wi"].blocks == 1
        assert "blocks.b0.ffn.wi" in split and "blocks.b0.ffn.wo" not in split
    if name == "ds-mla":  # MLA's up-projections whole, wo split; the shared expert's wo whole
        mla = {k for k in model.layout if ".attn.w_u" in k}
        assert mla and not mla & split and "blocks.b0.attn.wo" in split
        shared = [k for k in model.layout if ".shared" in k and k.endswith("wo")]
        assert shared and not set(shared) & split


@pytest.mark.parametrize("name", NAMES)
def test_model_8_trains_as_jax(runs, name):
    """The case's steps on (1, 8): each rank's losses, grad-norms and the
    parameters gathered whole against JAX's GSPMD; every leaf whole on
    ``model`` the same on every rank (its gradient was)."""
    ref, results = runs["jax"], _job(runs, name, "steps")
    whole = _whole_on_model(name)
    prefix = f"{name}/params/"
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    for res in results:
        np.testing.assert_allclose(res["loss"], ref[f"{name}/loss"], **GRAD_TOL)
        np.testing.assert_allclose(res["grad_norm"], ref[f"{name}/grad_norm"], **GRAD_TOL)
        assert set(res["params"]) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(res["params"][key], w, err_msg=f"{name} {key}",
                                       **GRAD_TOL)
        for key in whole:
            np.testing.assert_array_equal(res["params"][key], results[0]["params"][key],
                                          err_msg=f"{name} {key} rank {res['coords']}")


@pytest.mark.parametrize("name", NAMES)
def test_model_8_first_gradient_matches_jax(runs, name):
    """The gradient of every leaf at the initial weights on the first batch,
    gathered whole from each rank's blocks, against ``jax.grad``; each leaf
    whole on ``model`` takes the same gradient on every rank (a whole
    weight feeding work cut to the rank's columns gets only that rank's
    share unless the cut's backward gathers)."""
    prefix = f"{name}/grad/"
    want = {k[len(prefix):]: v for k, v in runs["jax"].items() if k.startswith(prefix)}
    results = _job(runs, name, "grads")
    for res in results:
        assert set(res) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(res[key], w, err_msg=f"{name} {key}", **GRAD_TOL)
    for key in _whole_on_model(name):
        for res in results[1:]:
            np.testing.assert_array_equal(res[key], results[0][key], err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", NAMES)
def test_model_8_prefill_and_decode_logits_match_jax(runs, name):
    """The prefill's last-token logits and one decode step's, whole over the
    vocab on every rank, against JAX's (1, 8) steps."""
    for res in _job(runs, name, "logits"):
        np.testing.assert_allclose(res["prefill"], runs["jax"][f"{name}/prefill"], **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], runs["jax"][f"{name}/decode"], **GRAD_TOL)


def test_xlstm_on_model_8_serves_jax_tokens(runs):
    """serve(mesh_shape=(1, 8)) of smoke xlstm-1.3b from JAX's weights and
    prompts: every rank returns JAX's greedy tokens."""
    for tokens in _job(runs, "xlstm", "serve"):
        np.testing.assert_array_equal(tokens, runs["jax"]["xlstm/tokens"])
        assert tokens.shape == (SERVE["batch"], SERVE["gen_len"])


def test_wq_gradient_matches_jax_and_a_plain_cut_misses_it(runs):
    """The gradient of the mLSTM's whole ``wq`` at the initial weights on
    every rank against JAX's; with the cell's output cut to the rank's
    columns by a plain slice (the planted fault) each rank's lies outside
    the tolerance, and the ranks' differ."""
    want = runs["jax"][f"xlstm/grad/{PROBE}"]
    faults = []
    for rank in runs["ranks"]:
        sound, fault = rank["xlstm", "grads"][PROBE], rank["xlstm", "fault"][PROBE]
        np.testing.assert_allclose(sound, want, **GRAD_TOL)
        assert not np.allclose(fault, want, **GRAD_TOL)
        faults.append(fault)
    assert not np.allclose(faults[0], faults[1], **GRAD_TOL)


def test_mla_heads_that_do_not_divide_prefill_as_one_process(runs):
    """Smoke deepseek-v2's 4 MLA heads over 8 ranks: the up-projections whole,
    ``wo`` split on its ``H·dv`` rows; its shared expert's width (12) does
    not divide either, so its output is whole and joins the routed experts'
    after *g*; the prefill's and a decode step's logits on every rank as the
    port's one process from the same weights (both held to JAX above)."""
    for res in _job(runs, "ds-mla", "logits"):
        np.testing.assert_allclose(res["prefill"], runs["ds"]["prefill"], **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], runs["ds"]["decode"], **GRAD_TOL)


def test_phase_14_rehearses_at_smoke_width_on_the_cpu(runs):
    """chip_smoke.py's phase 14 at smoke width in fp32 on 8 CPU ranks:
    xlstm-1.3b's 4 heads over 8 served, trained one step and its whole
    ``wq``'s gradient probed, each check passing and the planted fault
    outside its limit (the checks raise otherwise); they fail when a step
    counts 4 bytes more than the formulas, when a decode step's bytes
    differ, and when the fault's gradient equals the sound one."""
    import copy

    cs = torch_rank_fns._chip_smoke()
    ranks, ref = _job(runs, "rehearsal", "ranks"), runs["rehearsal"]
    (arch, over, batch, plen, _, _), = REHEARSE_SERVE
    cfg = get_config(arch, smoke=True).with_overrides(**over)
    serving = [r["serve"][0] for r in ranks]
    gap, faults = cs.check_tp_recurrent_serving(serving, cfg, batch, plen, ref["logits"], None,
                                                REHEARSE_MESH, "uneven")
    assert gap <= cs.TP_LOGITS_RTOL and not faults
    wrong = copy.deepcopy(serving)
    wrong[3]["decode_bytes"][0]["model"] += 4
    with pytest.raises(AssertionError, match="decode wire bytes"):
        cs.check_tp_recurrent_serving(wrong, cfg, batch, plen, ref["logits"], None,
                                      REHEARSE_MESH, "uneven")
    (arch, over, rows, seq, micro, n_steps, _, _), = REHEARSE_TRAIN
    training = [r["train"][0] for r in ranks]
    cs.check_tp_recurrent_training(training, cfg, (rows, seq, micro, n_steps), ref["first"],
                                   None, REHEARSE_MESH, "uneven")
    extra = copy.deepcopy(training)
    extra[5]["history"][0]["wire_bytes"]["model"] += 4
    with pytest.raises(AssertionError, match="wire bytes"):
        cs.check_tp_recurrent_training(extra, cfg, (rows, seq, micro, n_steps), ref["first"],
                                       None, REHEARSE_MESH, "uneven")
    sound, fault = cs.check_grad_probe(ranks, get_config(XL, smoke=True), PROBE, ref["probe"],
                                       REHEARSE_MESH, "uneven", "a plain cut")
    assert max(sound) < 1e-5 < min(fault)
    blind = copy.deepcopy(ranks)
    blind[0]["probe"]["fault"] = blind[0]["probe"]["sound"]
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_grad_probe(blind, get_config(XL, smoke=True), PROBE, ref["probe"],
                            REHEARSE_MESH, "uneven", "a plain cut")
