"""FSDP and tensor parallelism over gloo ranks against the JAX package on a
``(data, model)`` mesh.

JAX runs once, in a subprocess with four host devices (``conftest``'s
``run_multidevice``), on a (2, 2) mesh: smoke llama3.2-1b in fp32 from
``PRNGKey(0)``, three steps of ``build_train_step`` (flat, two
microbatches), ``serve(mesh_shape=(2, 2))``, and the logits of
``build_prefill_step`` and one ``build_decode_step``.  Beside it the port
runs on 4 gloo ranks in one spawn, from the same initial parameters (each
rank its blocks of them), and on 2 ranks in another: hubert-xlarge and
internvl2-76b at (1, 2) and every non-MoE arch at (2, 1) against the port's
one-process step, which the other test files hold to JAX (with hubert's
encode step, 2 x 2048 positions of the chunked vocab-parallel
cross-entropy, and an admitted serve whose lease rank 0 alone holds).  Then
the (2, 2) checkpoint loads under JAX's ``train_state_specs`` and resumes
at (1, 1), the CLI trains on (2, 2) under a process group, and
``chip_smoke.py``'s
phase 8 rehearses at smoke width, its checks shown to fail on planted
faults."""

import copy
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import train_state_specs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.models import Model, input_specs  # noqa: E402

import torch_rank_fns  # noqa: E402
from conftest import run_multidevice  # noqa: E402

LLAMA, HUBERT = "llama3.2-1b", "hubert-xlarge"
STEPS, B, T = 3, 8, 16
RUN = dict(learning_rate=1e-3, warmup_steps=0, microbatches=2)
SERVE = dict(batch=4, prompt_len=8, gen_len=4)
# fp32 on both sides: summation order only (tests/test_torch_train.py's).
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_AXIS = (HUBERT, "internvl2-76b")
DATA_AXIS = tuple(a for a in ARCHS if get_config(a, smoke=True).moe is None)
# chip_smoke.py's phase 8 at smoke width: rows, positions (2048: the chunked
# cross-entropy, as at 4096), steps; serving 8 x 64, 6 tokens.
REHEARSE_TRAIN, REHEARSE_SERVE = (4, 2048, 1), (8, 64, 6)
# One step of 2 rows of 2048 positions: the vocab-parallel cross-entropy in
# chunked_xent's chunks, each recomputed in the backward.
LONG = np.random.default_rng(8).integers(0, 256, (1, 2, 2049))
LONG_RUN = dict(RUN, microbatches=1)

JAX_REF = """
import jax, jax.numpy as jnp, numpy as np
import repro.launch.serve as serve_mod
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

fp32 = lambda a, smoke=True: get_config(a, smoke=smoke).with_overrides(dtype='float32')
cfg = fp32(ARCH)
mesh = make_mesh((2, 2), ('data', 'model'))
model = Model(cfg)
run = RunConfig(total_steps=10, **RUN)
toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (STEPS, B, T + 1))
res = {}
with set_mesh(mesh):
    step, _, state_sh, batch_sh = build_train_step(model, run, mesh, ShapeConfig('t', T, B, 'train'))
    state = jax.device_put(init_train_state(model, run, jax.random.PRNGKey(0)), state_sh)
    for i in range(STEPS):
        batch = {'tokens': toks[i, :, :-1].astype(np.int32), 'labels': toks[i, :, 1:].astype(np.int32)}
        state, m = step(state, jax.device_put(batch, batch_sh))
        for key in ('loss', 'grad_norm'):
            res.setdefault(key, []).append(float(m[key]))
    for k, v in flat(jax.device_get(state['params'])).items():
        res[f'params/{k}'] = v
    bs, plen, glen = SERVE['batch'], SERVE['prompt_len'], SERVE['gen_len']
    pshape = ShapeConfig('serve', plen, bs, 'prefill')
    prefill, _, (param_sh, pbatch_sh, _) = build_prefill_step(model, mesh, pshape, plen + glen)
    decode, _, _ = build_decode_step(model, mesh, ShapeConfig('serve', plen + glen, bs, 'decode'), plen + glen)
    params = jax.device_put(model.init(jax.random.PRNGKey(0)), param_sh)
    prompts = input_specs(cfg, pshape, concrete=True, rng=jax.random.PRNGKey(1))
    logits, caches = prefill(params, jax.device_put(prompts, pbatch_sh))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    dlogits, _ = decode(params, caches, tok)
    res['prefill'], res['decode'] = np.asarray(logits[:, -1]), np.asarray(dlogits[:, -1])
serve_mod.get_config = fp32
res['tokens'] = np.asarray(serve_mod.serve(ARCH, mesh_shape=(2, 2), **SERVE)['tokens'])
np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
print('OK ref')
"""


def _flat_jax(tree, prefix=""):
    return {k: v.numpy() for k, v in params_from_jax(jax.device_get(tree), prefix).items()}


def _batches(arch, steps=STEPS):
    vocab = get_config(arch, smoke=True).vocab_size
    return np.random.default_rng(7).integers(0, vocab, (steps, B, T + 1))


def _one_process(arch, params, batches, run_kw):
    """The port's one-device steps from ``params`` over ``batches``."""
    model = Model(torch_rank_fns._fp32(arch), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    run = RunConfig(total_steps=10, **run_kw)
    state, step = init_train_state(model, run), build_train_step(model, run)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, torch_rank_fns._batch(b, model.cfg))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms,
            "params": {k: v.detach().numpy() for k, v in state["params"].items()}}


def _one_encode(params, embeds):
    """The port's one-device encode of ``embeds`` (hubert, smoke, fp32)."""
    from repro_torch.launch.steps import build_encode_step

    model = Model(torch_rank_fns._fp32(HUBERT), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return build_encode_step(model)({"embeds": torch.from_numpy(embeds)}).numpy()


def _init(arch):
    return {k: v.detach().numpy() for k, v in Model(
        torch_rank_fns._fp32(arch), device="cpu").state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 4-rank spawn and the 2-rank spawn side by
    side; meanwhile, in this process, the one-process references."""
    cfg = jax_config(LLAMA, smoke=True).with_overrides(dtype="float32")
    params = _flat_jax(JaxModel(cfg).init(jax.random.PRNGKey(0)))
    pshape = JaxShapeConfig("serve", SERVE["prompt_len"], SERVE["batch"], "prefill")
    prompts = {k: np.asarray(v) for k, v in jax_input_specs(
        cfg, pshape, concrete=True, rng=jax.random.PRNGKey(1)).items()}
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    head = (f"ARCH, RUN, SERVE = {LLAMA!r}, {RUN!r}, {SERVE!r}\n"
            f"STEPS, B, T, OUT = {STEPS}, {B}, {T}, {str(out)!r}\n")
    ckpt, cli = (str(tmp_path_factory.mktemp(n)) for n in ("ckpt_tp", "cli_tp"))
    train_kw = dict(**RUN, total_steps=3, checkpoint_every=2, checkpoint_dir=ckpt)
    rows, seq, steps = REHEARSE_TRAIN
    cs = _chip_smoke()
    lr = cs.TP_TRAIN[-1]
    four = [("tp_steps", (LLAMA, (2, 2), params, _batches(LLAMA), RUN)),
            ("tp_serve", (LLAMA, (2, 2), params, prompts, *SERVE.values())),
            ("tp_logits", (LLAMA, (2, 2), params, prompts,
                           SERVE["prompt_len"] + SERVE["gen_len"])),
            ("train_fp32", (LLAMA, (2, 2), 3, train_kw, False, torch_rank_fns.DATA_MODEL)),
            ("cli_main", (["--arch", LLAMA, "--steps", "1", "--seq-len", "16", "--batch", "8",
                           "--ckpt-dir", cli, "--mesh-shape", "2,2", "--mesh-axes",
                           "data,model", "--device", "cpu"],)),
            ("chip_smoke_tp_train_rank", (LLAMA, rows, seq, 1, steps, lr, True, "cpu"))]
    inits = {a: _init(a) for a in set(MODEL_AXIS + DATA_AXIS)}
    two = [("tp_steps", (a, (1, 2), inits[a], _batches(a, 1), RUN)) for a in MODEL_AXIS]
    two += [("tp_steps", (a, (2, 1), inits[a], _batches(a, 1), RUN)) for a in DATA_AXIS]
    two.append(("tp_steps", (LLAMA, (1, 2), inits[LLAMA], LONG, LONG_RUN)))
    embeds = torch_rank_fns._batch(_batches(HUBERT, 1)[0], get_config(HUBERT, smoke=True))
    embeds = embeds["embeds"].numpy()
    two.append(("tp_encode", (HUBERT, (1, 2), inits[HUBERT], embeds)))
    two.append(("tp_serve_admitted", (LLAMA, (1, 2), 2)))
    two.append(("chip_smoke_tp_serve_rank", (LLAMA, *REHEARSE_SERVE, True, "cpu")))
    with ThreadPoolExecutor(3) as pool:
        jax_run = pool.submit(run_multidevice, head + JAX_REF, devices=4, timeout=600)
        ranks4 = pool.submit(spawn_ranks, torch_rank_fns.ranks_main, 4, (four,), timeout=600)
        ranks2 = pool.submit(spawn_ranks, torch_rank_fns.ranks_main, 2, (two,), timeout=600)
        one = {a: _one_process(a, inits[a], _batches(a, 1), RUN) for a in inits}
        one["encode"] = _one_encode(inits[HUBERT], embeds)
        one["long"] = _one_process(LLAMA, inits[LLAMA], LONG, LONG_RUN)
        one["admitted"] = serve(LLAMA, batch=2, prompt_len=8, gen_len=10,
                                device="cpu")["tokens"].numpy()
        one[LLAMA + "/jax-init"] = _one_process(LLAMA, params, _batches(LLAMA), RUN)
        rehearsal = _rehearsal_refs(cs)
        assert "OK ref" in jax_run.result()
        with np.load(out) as f:
            ref = {k: f[k] for k in f.files}
        return {"jax": ref, "four": ranks4.result(), "two": ranks2.result(), "one": one,
                "params": params, "prompts": prompts, "ckpt": ckpt, "cli": cli,
                "train_kw": train_kw, "rehearsal": rehearsal}


def _chip_smoke():
    return torch_rank_fns._chip_smoke()


def _rehearsal_refs(cs):
    """One rank's references of phase 8 at smoke width (bf16): the prefill's
    last-token logits and the served tokens; step 1's loss and grad-norm."""
    batch, plen, glen = REHEARSE_SERVE
    cfg = get_config(LLAMA, smoke=True)
    model = Model(cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(0))
    prompts = input_specs(cfg, ShapeConfig("serve", plen, batch, "prefill"),
                          generator=torch.Generator("cpu").manual_seed(1), device="cpu")
    logits = model.prefill(prompts, plen + glen)[0][:, -1].float().numpy()
    tokens = serve(LLAMA, batch=batch, prompt_len=plen, gen_len=glen, device="cpu")["tokens"]
    rows, seq, steps = REHEARSE_TRAIN
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        hist = train_mod.train(LLAMA, steps=1, shape=ShapeConfig("train_4k", seq, rows, "train"),
                               run=RunConfig(learning_rate=cs.TP_TRAIN[-1], warmup_steps=0,
                                             total_steps=steps, microbatches=2,
                                             checkpoint_every=10 ** 9, checkpoint_dir=tmp),
                               log_every=1, device="cpu")["history"]
    return {"logits": logits, "tokens": tokens.numpy(),
            "train": (hist[0]["loss"], hist[0]["grad_norm"])}


def _close(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, err_msg=f"{what} {key}", **GRAD_TOL)


def test_four_ranks_train_as_jax_on_data_2_model_2(runs):
    """Each rank's losses and grad-norms, and the final parameters gathered
    whole, against JAX's (2, 2) build_train_step; every rank puts bytes on
    data, model and world."""
    ref = runs["jax"]
    for rank in runs["four"]:
        res = rank[0]
        np.testing.assert_allclose(res["loss"], ref["loss"], **GRAD_TOL)
        np.testing.assert_allclose(res["grad_norm"], ref["grad_norm"], **GRAD_TOL)
        _close(res["params"], {k[7:]: v for k, v in ref.items() if k.startswith("params/")},
               f"rank {res['coords']}")
        assert all(set(w) == {"data", "model", "world"} for w in res["wire"])
    one = runs["one"][LLAMA + "/jax-init"]
    np.testing.assert_allclose(one["loss"], ref["loss"], **GRAD_TOL)


def test_meta_dry_run_wire_bytes_equal_a_gloo_ranks(runs):
    """Each rank's first step on (2, 2) over gloo against the same step of
    that rank on a mesh of the meta device with no process group
    (``launch/dryrun.py``): every group's wire bytes equal."""
    from repro_torch.launch import dryrun

    shape = ShapeConfig("train", T, B, "train")
    for r, rank in enumerate(runs["four"]):
        _, _, mesh, *_ = dryrun.run_rank(
            LLAMA, shape, False, "sync", microbatches=RUN["microbatches"], rank=r,
            cfg=torch_rank_fns._fp32(LLAMA), mesh_shape=((2, 2), ("data", "model")))
        assert mesh.coords == rank[0]["coords"]
        assert dict(mesh.traffic.wire_bytes) == rank[0]["wire"][0]


def test_serve_on_data_2_model_2_gives_jax_tokens(runs):
    """serve(mesh_shape=(2, 2)) from JAX's weights and prompts: every rank
    returns JAX's whole [batch, gen_len] tokens."""
    for rank in runs["four"]:
        np.testing.assert_array_equal(rank[1], runs["jax"]["tokens"])
        assert rank[1].shape == (SERVE["batch"], SERVE["gen_len"])


def test_prefill_and_decode_logits_match_jax(runs):
    """Each rank's rows' last-token logits over the whole vocab, from the
    prefill and one decode step, against JAX's (2, 2) steps' rows."""
    ref, half = runs["jax"], SERVE["batch"] // 2
    for rank in runs["four"]:
        res = rank[2]
        rows = slice(res["coords"]["data"] * half, (res["coords"]["data"] + 1) * half)
        np.testing.assert_allclose(res["prefill"], ref["prefill"][rows], **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], ref["decode"][rows], **GRAD_TOL)


def test_checkpoint_of_data_2_model_2_loads_in_jax_and_resumes_on_one_rank(runs, monkeypatch):
    """train() on (2, 2) wrote a step-2 checkpoint of whole tensors: it loads
    under JAX's train_state_specs (swiglu's wi as [gate | up]), and resumed
    on one rank its step 3 is within GRAD_TOL of step 3 on (2, 2)."""
    hist = runs["four"][0][3]
    assert [h["step"] for h in hist] == [1, 2, 3]
    run = JaxRunConfig(**{k: v for k, v in runs["train_kw"].items() if k != "checkpoint_dir"})
    model = JaxModel(jax_config(LLAMA, smoke=True).with_overrides(dtype="float32"))
    shapes, _ = train_state_specs(model, run)
    state, step, _ = jax_load_checkpoint(runs["ckpt"], shapes, step=2)
    assert step == 2
    flat = _flat_jax(state["params"])
    want = {k: tuple(v.shape) for k, v in Model(torch_rank_fns._fp32(LLAMA),
                                                device="cpu").state_dict().items()}
    assert {k: v.shape for k, v in flat.items()} == want
    real = train_mod.get_config
    monkeypatch.setattr(train_mod, "get_config",
                        lambda a, smoke: real(a, smoke).with_overrides(dtype="float32"))
    resumed = train_mod.train(LLAMA, steps=3, shape=ShapeConfig("t", T, B, "train"),
                              run=RunConfig(**runs["train_kw"]), resume=True, log_every=1,
                              device="cpu")["history"]
    assert [h["step"] for h in resumed] == [3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(resumed[0][key], hist[2][key], err_msg=key, **GRAD_TOL)


def test_cli_trains_on_data_2_model_2(runs):
    """The CLI with --mesh-shape 2,2 --mesh-axes data,model inside the ranks'
    process group writes a checkpoint of whole tensors."""
    model = JaxModel(jax_config(LLAMA, smoke=True))
    shapes, _ = train_state_specs(model, JaxRunConfig(total_steps=1))
    state, step, _ = jax_load_checkpoint(runs["cli"], shapes, step=1)
    assert step == 1
    assert all(np.all(np.isfinite(np.asarray(v, np.float32)))
               for v in jax.tree.leaves(state["params"]))


def _held_to_one_process(res, one):
    np.testing.assert_allclose(res["loss"], one["loss"], **GRAD_TOL)
    np.testing.assert_allclose(res["grad_norm"], one["grad_norm"], **GRAD_TOL)
    _close(res["params"], one["params"], f"rank {res['coords']}")


@pytest.mark.parametrize("arch", MODEL_AXIS)
def test_model_axis_trains_as_one_process(runs, arch):
    """The stub frontends on (1, 2): hubert's audio encoder (no causal mask,
    its embedding never read) and internvl2's vision decoder."""
    i = MODEL_AXIS.index(arch)
    for rank in runs["two"]:
        _held_to_one_process(rank[i], runs["one"][arch])


@pytest.mark.parametrize("arch", DATA_AXIS)
def test_data_axis_trains_as_one_process(runs, arch):
    """FSDP alone (2, 1) for every arch without MoE: RG-LRU and xLSTM blocks
    gathered on use as the dense ones."""
    i = len(MODEL_AXIS) + DATA_AXIS.index(arch)
    for rank in runs["two"]:
        _held_to_one_process(rank[i], runs["one"][arch])
        assert set(rank[i]["wire"][0]) == {"data", "world"}


def test_chunked_cross_entropy_on_model_2_is_one_process(runs):
    """2 x 2048 positions on (1, 2): the vocab-parallel cross-entropy in
    chunks of 1024 under remat, loss, grad-norm and parameters as one
    process."""
    for rank in runs["two"]:
        _held_to_one_process(rank[-4], runs["one"]["long"])


def test_encode_step_on_model_2_is_one_process(runs):
    """hubert's build_encode_step on (1, 2): every rank returns the whole
    [B, T, V] logits (its vocab of 64 split over model), as one process."""
    for rank in runs["two"]:
        np.testing.assert_allclose(rank[-3], runs["one"]["encode"], **GRAD_TOL)
        assert rank[-3].shape == (B, T, get_config(HUBERT, smoke=True).vocab_size)


def test_admitted_serve_on_model_2_takes_one_lease(runs):
    """serve() on (1, 2) with 2 admission slots: rank 0 takes, renews and
    releases one lease (one grant, a keepalive after prefill and after 8
    decode steps, no expiry) while rank 1 waits on it and holds none; both
    return one process's tokens."""
    (tok0, adm0), (tok1, adm1) = (rank[-2] for rank in runs["two"])
    assert adm1 is None
    assert adm0["grants"] == 1 and adm0["fast_renews"] == 2 and adm0["expirations"] == 0
    assert adm0["local_rdma_ops"] == 0 and adm0["slot_key"] == "serve/slot0"
    np.testing.assert_array_equal(tok0, runs["one"]["admitted"])
    np.testing.assert_array_equal(tok1, tok0)


def test_phase_8_rehearses_at_smoke_width_on_the_cpu(runs):
    """chip_smoke.py's phase 8 at smoke width (bf16) on CPU ranks: serving
    on (1, 2) and training on (2, 2), its checks passing; they fail when a
    step counts 4 bytes more, when the fault's loss equals the sound one,
    and when a rank holds a whole replica's state."""
    cs = _chip_smoke()
    ref, cfg = runs["rehearsal"], get_config(LLAMA, smoke=True)
    batch, plen, _ = REHEARSE_SERVE
    serving = [rank[-1] for rank in runs["two"]]
    assert cs.check_tp_serving(serving, cfg, batch, plen, ref["logits"], ref["tokens"],
                               None) <= cs.TP_LOGITS_RTOL
    training = [rank[-1] for rank in runs["four"]]
    rows, seq, steps = REHEARSE_TRAIN
    real = cs.TP_TRAIN
    cs.TP_TRAIN = (LLAMA, rows, seq, 1, steps, real[-1])
    try:
        gaps = cs.check_tp_training(training, cfg, ref["train"], None, None)
        assert all(map(math.isfinite, gaps))
        extra = copy.deepcopy(training)
        extra[1]["history"][0]["wire_bytes"]["data"] += 4
        with pytest.raises(AssertionError, match="wire bytes"):
            cs.check_tp_training(extra, cfg, ref["train"], None, None)
        blind = copy.deepcopy(training)
        blind[0]["fault"] = (blind[0]["history"][0]["loss"], blind[0]["history"][0]["grad_norm"])
        with pytest.raises(AssertionError, match="cannot tell"):
            cs.check_tp_training(blind, cfg, ref["train"], None, None)
        whole = copy.deepcopy(training)
        whole[2]["param_bytes"], whole[2]["moment_bytes"] = cs.shard_bytes(cfg, (1, 1))
        with pytest.raises(AssertionError, match="its blocks by the rules"):
            cs.check_tp_training(whole, cfg, ref["train"], None, None)
    finally:
        cs.TP_TRAIN = real
