"""Tensor parallelism of RG-LRU and xLSTM blocks, and the head-dim split of
KV heads that do not divide over ``model``, over gloo ranks against the JAX
package's GSPMD.

JAX runs once, in a subprocess with four host devices (``conftest``'s
``run_multidevice``), in fp32 from ``PRNGKey(0)``: smoke recurrentgemma-9b
and xlstm-1.3b on a (1, 2) mesh (three steps of ``build_train_step``, the
logits of ``build_prefill_step`` and one ``build_decode_step``, and the
greedy tokens of those steps, the loop that ``serve()`` runs); xlstm-1.3b at
d_model 96, whose sLSTM FFN takes the ``[gate_m | up_m]`` layout that the
published width takes (one step, the prefill's logits); smoke llama3.2-1b on
(1, 4), whose 2 KV heads split their head dim (one step, the prefill's and a
decode step's logits).  Beside it the port runs on 2 gloo ranks in one
spawn and on 4 in another, from the same parameters: those steps, logits
and ``serve()``'s tokens (and smoke glm4-9b's step on (1, 4), its 2 KV heads
split too, against the port's one process); the gradients of ``sharding/shard.py``'s four
exchanges over ``model`` against ``torch.autograd`` on the whole tensors;
RoPE applied to a rank's head-dim slice before the gather (a planted
fault), which must miss JAX's logits; and ``chip_smoke.py``'s phase 10
rehearsed at smoke width, its checks passing and failing where they
must."""

import copy
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
from repro_torch.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.models import Model, input_specs  # noqa: E402

import torch_rank_fns  # noqa: E402
from conftest import run_multidevice  # noqa: E402

RG, XL, LLAMA, GLM = "recurrentgemma-9b", "xlstm-1.3b", "llama3.2-1b", "glm4-9b"
STEPS, B, T = 3, 8, 16
# lr 1e-4 as in tests/test_torch_moe_train.py: after three AdamW steps at
# 1e-3, fp32 summation order alone (the port on one process against JAX's
# GSPMD too) moves a few elements whose gradients sit near AdamW's eps by
# up to 4e-5.  One microbatch: JAX compiles the step in half the time.
RUN = dict(learning_rate=1e-4, warmup_steps=0, microbatches=1)
SERVE = dict(batch=4, prompt_len=8, gen_len=4)
# fp32 on both sides: summation order only (tests/test_torch_train.py's).
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# (name, arch, config fields, model axis, steps, decode, served)
CASES = [(RG, RG, {}, 2, STEPS, True, True), (XL, XL, {}, 2, STEPS, True, True),
         ("xlstm-d96", XL, {"d_model": 96}, 2, 1, False, False),
         ("llama-model-4", LLAMA, {}, 4, 1, True, False)]
# chip_smoke.py's phase 10 at smoke width in fp32 (the card's limits are set
# for bf16 at published width; in bf16 the smoke models' step 1 reads up to
# 3.6e-5 from one rank's, on the card's 3e-5 limit): served (arch, config
# fields, rows, prompt, generated tokens, fault: the prompt passes
# recurrentgemma's window of 16), trained (arch, config fields, rows, tokens
# per row, microbatches, steps, lr, warmup), and the probe (arch, layers,
# tokens, key).
FP32 = {"dtype": "float32"}
REHEARSE_SERVE = ((RG, FP32, 4, 32, 4, "rope_before_gather"), (XL, FP32, 4, 32, 4, None))
REHEARSE_TRAIN = ((RG, FP32, 4, 64, 2, 2, 1e-3, 0), (XL, FP32, 4, 64, 1, 1, 1e-3, 0))
REHEARSE_PROBE = (XL, None, 32, "blocks.b0.cell.w_up")

JAX_REF = """
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

res = {}
for name, arch, over, M, steps, decode, served in CASES:
    cfg = get_config(arch, smoke=True).with_overrides(dtype='float32', **over)
    mesh = make_mesh((1, M), ('data', 'model'))
    model = Model(cfg)
    run = RunConfig(total_steps=10, **RUN)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (steps, B, T + 1))
    init = jax.device_get(jax.jit(lambda key: init_train_state(model, run, key))(jax.random.PRNGKey(0)))
    with set_mesh(mesh):
        step, _, state_sh, batch_sh = build_train_step(model, run, mesh, ShapeConfig('t', T, B, 'train'))
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
        if decode:
            # serve()'s loop: greedy tokens from these prefill and decode steps.
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


def _params(arch, over):
    """JAX's initial parameters of the case, drawn from ``PRNGKey(0)`` by the
    jitted ``init_train_state`` that its subprocess runs too."""
    model = JaxModel(jax_config(arch, smoke=True).with_overrides(dtype="float32", **over))
    run = JaxRunConfig(total_steps=10, **RUN)
    init = jax.jit(lambda key: train_state(model, run, key))(jax.random.PRNGKey(0))
    return {k: v.numpy() for k, v in params_from_jax(jax.device_get(init["params"])).items()}


def _prompts(arch, over):
    cfg = jax_config(arch, smoke=True).with_overrides(dtype="float32", **over)
    pshape = JaxShapeConfig("serve", SERVE["prompt_len"], SERVE["batch"], "prefill")
    return {k: np.asarray(v) for k, v in jax_input_specs(
        cfg, pshape, concrete=True, rng=jax.random.PRNGKey(1)).items()}


def _batches(arch, over, steps):
    vocab = get_config(arch, smoke=True).with_overrides(**over).vocab_size
    return np.random.default_rng(7).integers(0, vocab, (steps, B, T + 1))


def _port_params(arch):
    """The port's initial parameters of ``arch`` (smoke, fp32), numpy."""
    return {k: v.detach().numpy() for k, v in Model(torch_rank_fns._fp32(arch),
                                                    device="cpu").state_dict().items()}


def _one_process(arch, params, batches):
    """The port's one-process steps of ``arch`` (smoke, fp32) from ``params``."""
    model = Model(torch_rank_fns._fp32(arch), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    run = RunConfig(total_steps=10, **RUN)
    state, step = init_train_state(model, run), build_train_step(model, run)
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        state, m = step(state, torch_rank_fns._batch(b, model.cfg))
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    out["params"] = {k: v.detach().numpy() for k, v in state["params"].items()}
    return out


def _exchange_inputs():
    """Each model rank's x ``[2, 3, 8]`` and the weights of each exchange's
    output, and the tensor that every rank slices, for 2 ranks."""
    rng = np.random.default_rng(3)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    xs = [f(2, 3, 8) for _ in range(2)]
    ws = {"reduce_scatter": [f(2, 3, 4) for _ in range(2)],
          "all_reduce": [f(2, 3, 8) for _ in range(2)],
          "all_gather": [f(2, 6, 8) for _ in range(2)],
          "slice": [f(5, 4) for _ in range(2)]}
    return xs, ws, f(5, 8), (-1, 1, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, started first; then, from JAX's initial
    parameters, the 2-rank and the 4-rank spawns beside it; meanwhile, in
    this process, the rehearsal's one-rank references."""
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    head = (f"CASES, RUN, SERVE = {CASES!r}, {RUN!r}, {SERVE!r}\n"
            f"B, T, OUT = {B}, {T}, {str(out)!r}\n")
    with ThreadPoolExecutor(4) as pool:
        jax_run = pool.submit(run_multidevice, head + JAX_REF, devices=4, timeout=600)
        params = dict(zip([c[0] for c in CASES], pool.map(lambda c: _params(*c[1:3]), CASES)))
        prompts = {name: _prompts(arch, over) for name, arch, over, *_ in CASES}
        max_len = SERVE["prompt_len"] + SERVE["gen_len"]
        two, four = [], []
        for name, arch, over, M, steps, decode, served in CASES:
            jobs = two if M == 2 else four
            jobs.append(("tp_steps", (arch, (1, M), params[name], _batches(arch, over, steps),
                                      RUN, None, over)))
            jobs.append(("tp_logits", (arch, (1, M), params[name], prompts[name], max_len, None,
                                       over)))
            if served:
                jobs.append(("tp_serve", (arch, (1, M), params[name], prompts[name],
                                          *SERVE.values())))
        glm = _port_params(GLM)
        four.append(("tp_steps", (GLM, (1, 4), glm, _batches(GLM, {}, 1), RUN)))
        two.append(("tp_logits", (RG, (1, 2), params[RG], prompts[RG], max_len, None, None,
                                  "rope_before_gather")))
        two.append(("model_axis_grads", _exchange_inputs()))
        two.append(("chip_smoke_tp_recurrent_rank", (REHEARSE_SERVE, REHEARSE_TRAIN,
                                                     REHEARSE_PROBE, True, "cpu")))
        ranks2 = pool.submit(spawn_ranks, torch_rank_fns.ranks_main, 2, (two,), timeout=600)
        ranks4 = pool.submit(spawn_ranks, torch_rank_fns.ranks_main, 4, (four,), timeout=600)
        rehearsal = _rehearsal_refs(torch_rank_fns._chip_smoke())
        glm_one = _one_process(GLM, glm, _batches(GLM, {}, 1))
        assert "OK ref" in jax_run.result()
        with np.load(out) as f:
            ref = {k: f[k] for k in f.files}
        return {"jax": ref, "two": ranks2.result(), "four": ranks4.result(),
                "rehearsal": rehearsal, "glm": glm_one}


def _rehearsal_refs(cs):
    """One rank's references of phase 10 at smoke width (bf16): each served
    config's prefill logits, each trained config's step 1 (loss, grad-norm)
    and the probe's whole fp32 gradient."""
    logits, first = {}, {}
    for arch, over, batch, plen, glen, _ in REHEARSE_SERVE:
        cfg = get_config(arch, smoke=True).with_overrides(**over)
        model = Model(cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(0))
        prompts = input_specs(cfg, ShapeConfig("serve", plen, batch, "prefill"),
                              generator=torch.Generator("cpu").manual_seed(1), device="cpu")
        logits[arch] = model.prefill(prompts, plen + glen)[0][:, -1].float().numpy()
    for arch, over, rows, seq, micro, _, lr, warmup in REHEARSE_TRAIN:
        first[arch] = cs.one_rank_step(arch, over, rows, seq, micro, lr, warmup, True, "cpu")
    probe = cs.grad_probe(*REHEARSE_PROBE, smoke=True, device="cpu")["sound"]
    return {"logits": logits, "first": first, "probe": probe}


def _job(runs, ranks, name, kind):
    """Each rank's result of job ``kind`` of case ``name``."""
    jobs = []
    for case, arch, over, M, steps, decode, served in CASES:
        if (M == 2) == (ranks == "two"):
            jobs += [(case, "steps"), (case, "logits")] + ([(case, "serve")] if served else [])
    i = jobs.index((name, kind))
    return [rank[i] for rank in runs[ranks]]


def _close(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, err_msg=f"{what} {key}", **GRAD_TOL)


def _held_to_jax(runs, name, ranks):
    ref = runs["jax"]
    for res in _job(runs, ranks, name, "steps"):
        np.testing.assert_allclose(res["loss"], ref[f"{name}/loss"], **GRAD_TOL)
        np.testing.assert_allclose(res["grad_norm"], ref[f"{name}/grad_norm"], **GRAD_TOL)
        prefix = f"{name}/params/"
        _close(res["params"], {k[len(prefix):]: v for k, v in ref.items()
                               if k.startswith(prefix)}, f"{name} rank {res['coords']}")
        assert set(res["wire"][0]) == {"model", "world"}


@pytest.mark.parametrize("exchange", ["reduce_scatter", "all_reduce", "all_gather", "slice"])
def test_model_axis_exchange_has_the_whole_tensors_gradient(runs, exchange):
    """Each of shard.py's exchanges over model on 2 ranks: its output and
    each rank's gradient of the loss summed over ranks, against autograd on
    the whole tensors (the sum of the ranks' partials; the tensor that every
    rank slices).  The reduce-scatter and the slice take two blocks."""
    xs, ws, t, dims = _exchange_inputs()
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    whole = torch.from_numpy(t).requires_grad_()
    total = sum(leaves)
    pieces = {"reduce_scatter": lambda m: total.unflatten(-1, (2, 2, -1))[..., m, :].flatten(-2),
              "all_reduce": lambda m: total,
              "all_gather": lambda m: torch.cat(leaves, dim=1),
              "slice": lambda m: whole.unflatten(1, (2, 2, -1))[:, :, m].flatten(1)}[exchange]
    loss = sum((pieces(m) * torch.from_numpy(ws[exchange][m])).sum() for m in range(2))
    grads = torch.autograd.grad(loss, [whole] if exchange == "slice" else leaves)
    for m, rank in enumerate(runs["two"]):
        y, g = rank[-2][exchange]
        np.testing.assert_allclose(y, pieces(m).detach().numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, grads[0 if exchange == "slice" else m].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", [RG, XL])
def test_model_2_trains_as_jax(runs, name):
    """Three steps on (1, 2): each rank's losses and grad-norms, and the
    parameters gathered whole, against JAX's GSPMD; bytes on model and
    world only."""
    _held_to_jax(runs, name, "two")


@pytest.mark.parametrize("name", [RG, XL])
def test_model_2_prefill_and_decode_logits_match_jax(runs, name):
    """The prefill's last-token logits and one decode step's, whole over
    the vocab on every rank, against JAX's (1, 2) steps."""
    for res in _job(runs, "two", name, "logits"):
        np.testing.assert_allclose(res["prefill"], runs["jax"][f"{name}/prefill"], **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], runs["jax"][f"{name}/decode"], **GRAD_TOL)


@pytest.mark.parametrize("name", [RG, XL])
def test_model_2_serve_gives_jax_tokens(runs, name):
    """serve(mesh_shape=(1, 2)) from JAX's weights and prompts: every rank
    returns JAX's whole [batch, gen_len] greedy tokens."""
    for tokens in _job(runs, "two", name, "serve"):
        np.testing.assert_array_equal(tokens, runs["jax"][f"{name}/tokens"])
        assert tokens.shape == (SERVE["batch"], SERVE["gen_len"])


def test_paired_slstm_ffn_trains_and_prefills_as_jax(runs):
    """xlstm-1.3b at d_model 96: the sLSTM FFN's 2 x 128 columns split as
    [gate_m | up_m] and ffn_wo's rows split (the published width's layout;
    at smoke width 2 x 85 split contiguously and ffn_wo whole): one step
    and the prefill's logits against JAX's."""
    _held_to_jax(runs, "xlstm-d96", "two")
    for res in _job(runs, "two", "xlstm-d96", "logits"):
        np.testing.assert_allclose(res["prefill"], runs["jax"]["xlstm-d96/prefill"], **GRAD_TOL)


def test_head_dim_split_on_model_4_matches_jax(runs):
    """Smoke llama3.2-1b on (1, 4): its 2 KV heads do not split over 4
    ranks, so each rank holds half a head's head dim; one step, the
    prefill's and a decode step's logits against JAX's."""
    _held_to_jax(runs, "llama-model-4", "four")
    for res in _job(runs, "four", "llama-model-4", "logits"):
        np.testing.assert_allclose(res["prefill"], runs["jax"]["llama-model-4/prefill"],
                                   **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], runs["jax"]["llama-model-4/decode"],
                                   **GRAD_TOL)


def test_head_dim_split_on_model_4_trains_glm4_as_one_process(runs):
    """Smoke glm4-9b on (1, 4): its 2 KV heads split their head dim, as
    llama's; one step's loss, grad-norm and parameters on every rank as the
    port's one process (which the other files hold to JAX)."""
    want = runs["glm"]
    for rank in runs["four"]:
        res = rank[-1]
        np.testing.assert_allclose(res["loss"], want["loss"], **GRAD_TOL)
        np.testing.assert_allclose(res["grad_norm"], want["grad_norm"], **GRAD_TOL)
        _close(res["params"], want["params"], f"glm4 rank {res['coords']}")


def test_rope_on_a_head_dim_slice_misses_jax(runs):
    """The planted fault of phase 10(a): recurrentgemma's ranks rotate
    their own half of the one KV head before the gather; its prefill logits
    lie outside GRAD_TOL of JAX's."""
    for rank in runs["two"]:
        got = rank[-3]["prefill"]
        assert not np.allclose(got, runs["jax"][f"{RG}/prefill"], **GRAD_TOL)


def test_phase_10_rehearses_at_smoke_width_on_the_cpu(runs):
    """chip_smoke.py's phase 10 at smoke width (bf16) on CPU ranks: both
    archs served and trained on (1, 2) and the mLSTM's gradient probed,
    each check passing, each planted fault outside its limit (the checks
    raise otherwise); they fail when a step counts 4 bytes more, when a
    decode step's bytes differ, when the fault's logits equal the sound
    ones, and when the fault's gradient equals the sound one."""
    cs = torch_rank_fns._chip_smoke()
    ranks, ref = [rank[-1] for rank in runs["two"]], runs["rehearsal"]
    for i, (arch, over, batch, plen, _, fault) in enumerate(REHEARSE_SERVE):
        serving = [r["serve"][i] for r in ranks]
        gap, faults = cs.check_tp_recurrent_serving(
            serving, get_config(arch, smoke=True).with_overrides(**over), batch, plen,
            ref["logits"][arch], None)
        assert gap <= cs.TP_LOGITS_RTOL and len(faults) == (2 if fault else 0)
    for i, (arch, over, rows, seq, micro, n_steps, _, _) in enumerate(REHEARSE_TRAIN):
        training = [r["train"][i] for r in ranks]
        cfg = get_config(arch, smoke=True).with_overrides(**over)
        cs.check_tp_recurrent_training(training, cfg, (rows, seq, micro, n_steps),
                                       ref["first"][arch], None)
        extra = copy.deepcopy(training)
        extra[1]["history"][0]["wire_bytes"]["model"] += 4
        with pytest.raises(AssertionError, match="wire bytes"):
            cs.check_tp_recurrent_training(extra, cfg, (rows, seq, micro, n_steps),
                                           ref["first"][arch], None)
    cfg = get_config(RG, smoke=True).with_overrides(**FP32)
    serving = copy.deepcopy([r["serve"][0] for r in ranks])
    serving[0]["decode_bytes"][1]["model"] += 4
    with pytest.raises(AssertionError, match="decode wire bytes"):
        cs.check_tp_recurrent_serving(serving, cfg, 4, 32, ref["logits"][RG], None)
    blind = copy.deepcopy([r["serve"][0] for r in ranks])
    blind[1]["fault_logits"] = blind[1]["logits"]
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_tp_recurrent_serving(blind, cfg, 4, 32, ref["logits"][RG], None)
    sound, fault = cs.check_grad_probe(ranks, get_config(XL, smoke=True), REHEARSE_PROBE[3],
                                       ref["probe"])
    assert max(sound) < 1e-5 < min(fault)
    blind = copy.deepcopy(ranks)
    blind[0]["probe"]["fault"] = blind[0]["probe"]["sound"]
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_grad_probe(blind, get_config(XL, smoke=True), REHEARSE_PROBE[3], ref["probe"])
