"""The port's stub frontends and non-causal encoder against the JAX package:
``input_specs`` per frontend and kind, the plain flash path without the
causal mask at hubert's head dim 80, hubert-xlarge's encode logits,
internvl2-76b's prefill and teacher-forced decode, the loss and every
gradient of both (hubert's unread ``embed.table`` a zero gradient on both
sides), microbatched gradients, remat, and ``train()`` on embedding batches
against the reference's; smoke widths, fp32.  Then, on a card, hubert's
encode at smoke width through the ``wgmma`` flash kernel."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import train as jax_train_mod  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import _grad_fn as jax_grad_fn  # noqa: E402
from repro.launch.steps import init_train_state as jax_init_train_state  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.attention import online_attention  # noqa: E402
from repro.models.io import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import (build_encode_step, build_train_step,  # noqa: E402
                                      grad_fn, init_train_state)
from repro_torch.models import Model, input_specs  # noqa: E402
from repro_torch.optim import cosine_schedule  # noqa: E402

ARCHS = ("hubert-xlarge", "internvl2-76b")
# fp32 on both sides: summation order only (tests/test_torch_train.py's).
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# tests/test_torch_model.py's prefill and decode tolerances.
PREFILL_TOL = dict(atol=2e-4, rtol=1e-3)
DECODE_TOL = dict(atol=5e-3, rtol=1e-2)


def _models(arch, **overrides):
    jcfg = jax_config(arch, smoke=True).with_overrides(dtype="float32", **overrides)
    tcfg = get_config(arch, smoke=True).with_overrides(dtype="float32", **overrides)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jm, jp, tm


def _batch(cfg, B, T, seed=0, labels=True):
    """A numpy batch of ``cfg``'s frontend: embeds at 0.02 of a normal draw
    (audio: every position; vision: ``frontend_tokens`` of them, then text
    tokens), labels over the positions the loss covers."""
    rng = np.random.default_rng(seed)
    n_txt = T - cfg.frontend_tokens if cfg.frontend == "vision" else T
    n_emb = T if cfg.frontend == "audio" else cfg.frontend_tokens
    batch = {"embeds": (0.02 * rng.standard_normal((B, n_emb, cfg.d_model))).astype(np.float32)}
    toks = rng.integers(0, cfg.vocab_size, (B, n_txt + 1)).astype(np.int32)
    if cfg.frontend == "vision":
        batch["tokens"] = toks[:, :-1]
    if labels:
        batch["labels"] = toks[:, 1:]
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


def _close(out, expect, **tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect), **tol)


# ------------------------------------------------------------------ inputs --
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS + ("llama3.2-1b",))
def test_input_specs_match_the_references_shapes(arch, kind):
    """The reference's keys and shapes per frontend and kind; tokens and
    labels int64, embeddings in the dtype asked for, drawn at 0.02 of a
    normal on the generator's device."""
    shape = ShapeConfig("s", 24, 3, kind)
    want = jax_input_specs(jax_config(arch, smoke=True), JaxShapeConfig("s", 24, 3, kind))
    for dtype in (torch.bfloat16, torch.float32):
        got = input_specs(get_config(arch, smoke=True), shape, device=torch.device("cpu"),
                          generator=torch.Generator().manual_seed(0), dtype=dtype)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        for key, x in got.items():
            assert x.dtype == (dtype if key == "embeds" else torch.int64), key
        if "embeds" in got:
            assert 0.01 < got["embeds"].float().std().item() < 0.03


def test_input_specs_draw_from_the_callers_generator():
    cfg, shape = get_config("internvl2-76b", smoke=True), ShapeConfig("s", 16, 2, "train")
    draw = lambda seed: input_specs(cfg, shape, device=torch.device("cpu"),
                                    generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(3), draw(3), draw(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embeds"], c["embeds"])


# ------------------------------------------------------ non-causal flash --
@pytest.mark.parametrize("B,T,H,K,d", [(2, 37, 4, 4, 80), (1, 50, 8, 2, 80), (1, 21, 2, 1, 64)])
def test_plain_flash_without_causal_mask_matches_jax_online_attention(B, T, H, K, d):
    """Every query sees every key, at hubert's head dim 80 with a T that no
    block divides; JAX's blocked online softmax tiles it by 16."""
    rng = np.random.default_rng(B * T + H)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, d), (B, T, K, d), (B, T, K, d)))
    want = online_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                            q_block=16, k_block=16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for out in (ops.flash_attention(tq, tk, tv, False, 0),
                ref.flash_attention_ref(tq, tk, tv, causal=False)):
        _close(out, want, atol=2e-5, rtol=0)
    causal = ops.flash_attention(tq, tk, tv, True, 0)
    assert not np.allclose(causal.numpy(), np.asarray(want), atol=1e-2)


# ------------------------------------------------------------------ models --
def test_hubert_encode_matches_jax_forward_then_logits():
    jm, jp, tm = _models("hubert-xlarge")
    batch = _batch(jm.cfg, 2, 30, seed=1, labels=False)
    h, _ = jm.forward(jp, _jax(batch))
    want = jm._logits(jp, h)
    got = build_encode_step(tm)(_torch(batch))
    assert tuple(got.shape) == (2, 30, jm.cfg.vocab_size)
    assert got.is_inference() and not got.requires_grad
    _close(got, want, **PREFILL_TOL)


def test_internvl2_prefill_then_teacher_forced_decode():
    """4 image embeddings ahead of 20 text tokens, then 6 decode steps; the
    KV cache holds the image positions too."""
    jm, jp, tm = _models("internvl2-76b")
    B, T, steps = 2, 24, 6
    max_len = T + steps
    batch = _batch(jm.cfg, B, T, seed=2, labels=False)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)
    jl, jc = jprefill(jp, _jax(batch), max_len)
    tl, tc = tm.prefill(_torch(batch), max_len)
    assert tuple(tl.shape) == (B, 1, jm.cfg.vocab_size)
    _close(tl, jl, **PREFILL_TOL)
    jb, tb = jc["blocks"]["b0"], tc["blocks"]["b0"]
    _close(tb.k, jb.k, atol=1e-4, rtol=1e-3)
    _close(tb.v, jb.v, atol=1e-4, rtol=1e-3)
    assert tb.length == T
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok).long())
        _close(tl, jl, **DECODE_TOL)
        assert tc["blocks"]["b0"].length == T + step + 1


def test_internvl2_prefill_and_decode_match_its_forward():
    """The port's own forward over the image embeddings, the prompt and one
    more token, against its prefill and one decode step."""
    tm = Model(get_config("internvl2-76b", smoke=True).with_overrides(dtype="float32"),
               device="cpu")
    batch = _torch(_batch(tm.cfg, 2, 20, seed=3, labels=False))
    logits_p, cache = tm.prefill(batch, 24)
    tok = torch.randint(0, tm.cfg.vocab_size, (2, 1), generator=torch.Generator().manual_seed(9))
    logits_d, _ = tm.decode_step(cache, tok)
    with torch.no_grad():
        h, _ = tm.forward({"embeds": batch["embeds"],
                           "tokens": torch.cat([batch["tokens"], tok], dim=1)})
        want = tm._logits(h[:, -2:])
    torch.testing.assert_close(logits_p, want[:, :1], **PREFILL_TOL)
    torch.testing.assert_close(logits_d, want[:, 1:], **DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_jax(arch):
    """hubert: the audio stub replaces the embedding, so ``embed.table``'s
    gradient is zero on both sides, under its own key.  internvl2: the loss
    covers the text positions only."""
    jm, jp, tm = _models(arch)
    batch = _batch(jm.cfg, 2, 28, seed=4)
    (jloss, jmetrics), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, _jax(batch))
    loss, metrics, grads = grad_fn(tm, 1)(_torch(batch))
    assert set(metrics) == set(jmetrics) == {"ce", "loss"}
    _close(loss.item(), float(jloss), **GRAD_TOL)
    expect = params_from_jax(jax.device_get(jg))
    assert set(grads) == set(expect) == {n for n, _ in tm.named_parameters()}
    for key, g in grads.items():
        _close(g.numpy(), expect[key].numpy(), err_msg=key, **GRAD_TOL)
    table = grads["embed.table"]
    if arch == "hubert-xlarge":
        assert not table.any() and not expect["embed.table"].numpy().any()
    else:
        assert table.abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_grads_match_jax_grad_fn(arch):
    """Two microbatches summed in fp32; hubert's unread table stays a zero
    gradient through the sum."""
    jm, jp, tm = _models(arch)
    batch = _batch(jm.cfg, 4, 16, seed=5)
    with set_mesh(make_mesh((1, 1), ("data", "model"))):
        (jloss, _), jg = jax.jit(jax_grad_fn(jm.loss, 2))(jp, _jax(batch))
    loss, _, grads = grad_fn(tm, 2)(_torch(batch))
    _close(loss.item(), float(jloss), **GRAD_TOL)
    expect = params_from_jax(jax.device_get(jg))
    assert set(grads) == set(expect)
    for key, g in grads.items():
        assert g.dtype == torch.float32
        _close(g.numpy(), expect[key].numpy(), err_msg=key, **GRAD_TOL)
    assert (arch == "hubert-xlarge") == (not grads["embed.table"].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    _, _, tm = _models(arch)
    _, _, plain = _models(arch, remat="none")
    batch = _torch(_batch(tm.cfg, 2, 24, seed=6))
    l1, _, g1 = grad_fn(tm, 1)(batch)
    l2, _, g2 = grad_fn(plain, 1)(batch)
    assert l1.item() == l2.item()
    for key in g1:
        torch.testing.assert_close(g1[key], g2[key], atol=1e-7, rtol=1e-6)


def test_unread_parameter_is_decayed_as_the_reference_does():
    """Two train steps of hubert: ``embed.table`` has no gradient to follow, so
    each AdamW update is weight decay alone, ``p - lr wd p``, as JAX's
    ``adamw_update`` gives for a zero gradient."""
    tm = Model(get_config("hubert-xlarge", smoke=True).with_overrides(dtype="float32"),
               device="cpu")
    run = RunConfig(learning_rate=1e-2, warmup_steps=0, total_steps=4, weight_decay=0.1)
    state = init_train_state(tm, run)
    before = tm.embed["table"].detach().clone()
    step = build_train_step(tm, run)
    for _ in range(2):
        state, _ = step(state, _torch(_batch(tm.cfg, 2, 16, seed=7)))
    assert not state["opt"]["mu"]["embed.table"].any()
    want = before
    for i in range(2):
        lr = cosine_schedule(i, peak_lr=run.learning_rate, warmup=0, total=4)
        want = want - lr * (run.weight_decay * want)  # AdamW's update with delta 0
    assert not torch.equal(want, before)
    torch.testing.assert_close(tm.embed["table"].detach(), want, atol=0, rtol=0)


def test_batch_arrays_keep_their_kind_on_the_device():
    """Embeddings go to the device as float32 (the model casts them), tokens
    and labels as int64."""
    rng = np.random.default_rng(0)
    emb = (0.02 * rng.standard_normal((2, 3, 4))).astype(np.float32)
    got = train_mod.to_device(emb, torch.device("cpu"))
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(emb))
    toks = rng.integers(0, 9, (2, 3)).astype(np.int32)
    got = train_mod.to_device(toks, torch.device("cpu"))
    assert got.dtype == torch.int64 and torch.equal(got, torch.from_numpy(toks).long())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_curve_matches_jax_train(tmp_path, monkeypatch, arch):
    """``train()`` on embedding batches from the data pipeline, 4 fp32 steps
    of 2 microbatches from one JAX ``init_train_state`` (the port resumes the
    checkpoint the JAX package wrote at step 0): losses, grad-norms and the
    final weights, hubert's decayed ``embed.table`` among them."""
    steps = 4
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=steps,
              checkpoint_every=10 ** 9, microbatches=2)
    monkeypatch.setattr(jax_train_mod, "get_config",
                        lambda a, smoke: jax_config(a, smoke).with_overrides(dtype="float32"))
    monkeypatch.setattr(train_mod, "get_config",
                        lambda a, smoke: get_config(a, smoke).with_overrides(dtype="float32"))
    jrun = JaxRunConfig(checkpoint_dir=str(tmp_path / "jax"), **kw)
    run = RunConfig(checkpoint_dir=str(tmp_path / "port"), **kw)
    init = jax_init_train_state(JaxModel(jax_train_mod.get_config(arch, True)), jrun,
                                jax.random.PRNGKey(jrun.seed))
    jax_save_checkpoint(run.checkpoint_dir, 0, jax.device_get(init))
    expect = jax_train_mod.train(arch, steps=steps, run=jrun, log_every=1,
                                 shape=JaxShapeConfig("t", 24, 4, "train"))
    out = train_mod.train(arch, steps=steps, run=run, log_every=1, resume=True,
                          shape=ShapeConfig("t", 24, 4, "train"), device="cpu")
    for key in ("loss", "grad_norm"):
        _close([h[key] for h in out["history"]], [h[key] for h in expect["history"]],
               rtol=1e-4, atol=0)
    want = params_from_jax(jax.device_get(expect["final_state"]["params"]))
    got = out["final_state"]["params"]
    for key, p in got.items():
        _close(p.detach().numpy(), want[key].numpy(), err_msg=key, **GRAD_TOL)
    init_table = np.asarray(init["params"]["embed"]["table"])
    assert not np.array_equal(got["embed.table"].detach().numpy(), init_table)


# ------------------------------------------------- chip_smoke.py phase 6(f) --
def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only inside main)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grad_gaps_read_nan_as_infinite_and_unread_leaves_as_zero():
    """Phase 6(f)'s reading: a NaN gradient must not drop out of the worst
    leaf (``max`` over NaN keeps whatever came first), and a leaf that both
    sides leave at zero gaps 0, one side only infinitely."""
    cs = _chip_smoke()
    want = (1.0, {"table": torch.zeros(3), "w": torch.ones(3)})
    assert cs.grad_gaps((1.0, {"table": torch.zeros(3), "w": torch.ones(3)}), want)[:3] == (
        0.0, 0.0, 0.0)
    nan = cs.grad_gaps((1.0, {"table": torch.zeros(3), "w": torch.full((3,), float("nan"))}),
                       want)
    assert nan[1] == nan[2] == float("inf") and nan[3] == "w"
    moved = cs.grad_gaps((1.0, {"table": torch.ones(3), "w": torch.ones(3)}), want)
    assert moved[1] == float("inf") and moved[3] == "table"


def test_phase_6f_microbatch_check_sees_a_causal_recompute():
    """hubert at smoke width: the microbatch through ``ops`` (the plain
    versions, on the CPU) equals the plain versions swapped in, with
    ``embed.table``'s gradient exactly zero; the causal mask in remat's
    recompute alone exceeds phase 6(f)'s limits by far."""
    cs = _chip_smoke()
    model = Model(get_config("hubert-xlarge", smoke=True), device="cpu")
    mb = _torch(_batch(model.cfg, 2, 40, seed=8))
    L, plain, calls = model.cfg.num_layers, cs.plain_entries(), []

    def wrong_recompute(q, k, v, causal, window, scale, lse=False):
        calls.append(None)
        return plain["_flash_fwd"](q, k, v, causal or len(calls) > L, window, scale, lse)

    ours = cs.microbatch_grads(model, mb)
    want = cs.microbatch_grads(model, mb, plain)
    wrong = cs.microbatch_grads(model, mb, {**plain, "_flash_fwd": wrong_recompute})
    assert len(calls) == 2 * L
    assert not ours[1]["embed.table"].any() and not want[1]["embed.table"].any()
    assert cs.grad_gaps(ours, want)[:3] == (0.0, 0.0, 0.0)
    gaps = cs.grad_gaps(wrong, want)
    assert gaps[0] == 0.0 and gaps[1] > 10 * cs.HUBERT_TRAIN_BF16_TOL["grad"]


# ------------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_hubert_encode_on_card_launches_wgmma_per_layer(cuda):
    """hubert-xlarge at smoke width in bf16 on the card: each of its 2
    layers launches the flash kernel once, without the causal mask, on
    ``wgmma`` (head dim 16); no plain version runs; the logits are finite
    and near the card's own fp32 encode."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    cfg = get_config("hubert-xlarge", smoke=True)
    model = Model(cfg, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    batch = input_specs(cfg, ShapeConfig("e", 300, 2, "prefill"), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    plain = []
    real = ref.flash_attention_ref
    ref.flash_attention_ref = lambda *a, **k: plain.append(1) or real(*a, **k)
    try:
        before = dict(flash_attention_fwd.launches_by_variant)
        logits = build_encode_step(model)(batch)
        torch.cuda.synchronize()
    finally:
        ref.flash_attention_ref = real
    launched = {k: c - before[k] for k, c in flash_attention_fwd.launches_by_variant.items()}
    assert launched == {"simt": 0, "wgmma": cfg.num_layers} and not plain
    assert tuple(logits.shape) == (2, 300, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    f32 = Model(cfg.with_overrides(dtype="float32"), device=cuda)
    f32.load_state_dict(model.state_dict())
    want = build_encode_step(f32)(batch)
    assert ((logits.float() - want).norm() / want.norm()).item() < 2e-2
