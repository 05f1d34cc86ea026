"""The port's training path against the JAX package's, on the same weights
and batches: loss and every parameter's gradient (llama3.2-1b, the
recurrentgemma-9b hybrid and xlstm-1.3b, smoke widths, fp32), chunked cross-entropy, remat,
the tied embedding, the port's own forward against its prefill and decode,
and the card check of ``chip_smoke.py`` phase 6(a) at its smallest case.
The train step and the trainer are in ``tests/test_torch_steps.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ARCHS = ("llama3.2-1b", "recurrentgemma-9b", "xlstm-1.3b")
SUPPORTED = ("llama3.2-1b", "llama3-8b", "glm4-9b", "codeqwen1.5-7b", "recurrentgemma-9b",
             "xlstm-1.3b")
# fp32 on both sides: summation order only.
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _models(arch, **overrides):
    jcfg = jax_config(arch, smoke=True).with_overrides(dtype="float32", **overrides)
    tcfg = get_config(arch, smoke=True).with_overrides(dtype="float32", **overrides)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jm, jp, tm


def _batch(vocab, B, T, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _grads(tm, batch):
    loss, metrics = tm.loss(_torch(batch))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return loss.detach(), metrics, dict(zip(names, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_jax(arch):
    jm, jp, tm = _models(arch)
    batch = _batch(jm.cfg.vocab_size, 2, 32)
    (jloss, jmetrics), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, _jax(batch))
    loss, metrics, grads = _grads(tm, batch)
    assert set(metrics) == set(jmetrics) == {"ce", "loss"}
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD_TOL)
    expect = params_from_jax(jax.device_get(jg))
    assert set(grads) == set(expect)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), expect[key].numpy(), err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_at_2048_matches_softmax_xent_and_jax(masked):
    """Four chunks of 1024 under checkpoint give softmax_xent's value and
    gradient, and JAX's chunked_xent's value."""
    rng = np.random.default_rng(1)
    B, T, D, V = 1, 2048, 16, 48
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32) if masked else None
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w)
    tmask = None if mask is None else torch.from_numpy(mask)
    chunked = tl.chunked_xent(th, lambda hc: hc @ tw, torch.from_numpy(y).long(), tmask)
    (gc,) = torch.autograd.grad(chunked, th)
    plain = tl.softmax_xent(th @ tw, torch.from_numpy(y).long(), tmask)
    (gp,) = torch.autograd.grad(plain, th)
    np.testing.assert_allclose(chunked.item(), plain.item(), rtol=1e-6)
    np.testing.assert_allclose(gc.numpy(), gp.numpy(), atol=1e-9, rtol=1e-5)
    expect = jl.chunked_xent(jnp.asarray(h), lambda hc: hc @ jnp.asarray(w), jnp.asarray(y),
                             None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(chunked.item(), float(expect), rtol=1e-6)


def test_loss_takes_chunked_xent_from_t_2048(monkeypatch):
    tm = Model(get_config("llama3.2-1b", smoke=True).with_overrides(dtype="float32"),
               device="cpu")
    calls = []
    real = tl.chunked_xent
    monkeypatch.setattr("repro_torch.models.transformer.chunked_xent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        short, _ = tm.loss(_torch(_batch(256, 1, 2047)))
        assert calls == []
        long_, _ = tm.loss(_torch(_batch(256, 1, 2048)))
    assert calls == [1] and torch.isfinite(short) and torch.isfinite(long_)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    _, _, tm = _models(arch)
    _, _, plain = _models(arch, remat="none")
    batch = _batch(256, 2, 24, seed=4)
    l1, _, g1 = _grads(tm, batch)
    l2, _, g2 = _grads(plain, batch)
    assert l1.item() == l2.item()
    for key in g1:
        torch.testing.assert_close(g1[key], g2[key], atol=1e-7, rtol=1e-6)


def test_tied_embedding_grad_sums_lookup_and_logits():
    """The table feeds the lookup and the logits; its grad is the sum of the
    grads an untied copy gets on each use."""
    _, _, tm = _models("llama3.2-1b")
    raw = _batch(256, 2, 12, seed=5)
    _, _, grads = _grads(tm, raw)
    batch = _torch(raw)
    table = tm.embed["table"].detach()
    lookup, head = table.clone().requires_grad_(), table.clone().requires_grad_()
    x = tl.embed({"table": lookup}, batch["tokens"])
    x, _ = tm._train_stack(x)  # (hidden states, the MoE aux: 0 here)
    h = tl.rmsnorm(tm.final_norm, x)
    loss = tl.softmax_xent(h @ head.T, batch["labels"])
    g_lookup, g_head = torch.autograd.grad(loss, (lookup, head))
    assert g_lookup.abs().sum() > 0 and g_head.abs().sum() > 0
    torch.testing.assert_close(grads["embed.table"], g_lookup + g_head, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("arch", SUPPORTED)
def test_prefill_decode_matches_forward(arch):
    """The port's own forward against its own prefill and decode (the port
    of ``tests/test_models_smoke.py::test_prefill_decode_matches_forward``)."""
    tm = Model(get_config(arch, smoke=True).with_overrides(dtype="float32"), device="cpu")
    T, B, max_len = 24, 2, 32
    tokens = torch.from_numpy(_batch(tm.cfg.vocab_size, B, T, seed=6)["tokens"]).long()
    logits_p, cache = tm.prefill({"tokens": tokens}, max_len)
    with torch.no_grad():
        h0, aux = tm.forward({"tokens": tokens})
        ref_p = tm._logits(h0)[:, -1:]
    assert aux.item() == 0.0
    torch.testing.assert_close(logits_p, ref_p, atol=2e-4, rtol=1e-3)
    tok = torch.randint(0, tm.cfg.vocab_size, (B, 1), generator=torch.Generator().manual_seed(9))
    logits_d, _ = tm.decode_step(cache, tok)
    with torch.no_grad():
        h, _ = tm.forward({"tokens": torch.cat([tokens, tok], dim=1)})
        ref_d = tm._logits(h)[:, -1:]
    torch.testing.assert_close(logits_d, ref_d, atol=5e-3, rtol=1e-2)


def test_serving_keeps_inference_mode_and_trainable_parameters():
    tm = Model(get_config("llama3.2-1b", smoke=True), device="cpu")
    assert all(p.requires_grad for p in tm.parameters())
    logits, _ = tm.prefill({"tokens": torch.zeros((1, 4), dtype=torch.long)}, 8)
    assert logits.is_inference() and not logits.requires_grad


def test_train_state_shares_the_models_parameters():
    tm = Model(get_config("recurrentgemma-9b", smoke=True), device="cpu")
    state = init_train_state(tm, RunConfig(optimizer_state_dtype="bfloat16"))
    for key, p in tm.named_parameters():
        assert state["params"][key] is p
        assert state["opt"]["mu"][key].dtype == torch.bfloat16
        assert state["opt"]["mu"][key].shape == p.shape
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].item() == 0


@pytest.mark.parametrize("mode", ["sync", "local", "flat"])
def test_multi_pod_modes_are_refused(mode):
    """MoE over pods builds its step in every mode (at data 1 and 2): in
    sync and local each pod's rows routed over its own data ranks, as the
    reference's vmap over pods routes them, and in flat over the ``(pod,
    data)`` rows, as the reference's groups span them (``step_rows``)."""
    from repro_torch.launch.steps import step_rows

    cfg = get_config("deepseek-v2-236b", smoke=True)
    run = RunConfig(sync_mode=mode, compress_int8=mode == "sync")
    for sizes in ((2, 2), (2, 1)):
        mesh = Mesh(axes=("pod", "data"), shape=dict(zip(("pod", "data"), sizes)),
                    coords={"pod": 0, "data": 0}, device=torch.device("cpu"))
        tm = Model(cfg, device="cpu", mesh=mesh)
        assert (tm.mesh is mesh) == (sizes[1] > 1)
        assert callable(build_train_step(tm, run, mesh))
        assert step_rows(mode, mesh).axes == (("pod", "data") if mode == "flat" else ("data",))


def test_train_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: train() would run on it")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train("llama3.2-1b", steps=1, run=RunConfig(checkpoint_dir=str(tmp_path)))


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_grads_and_train_steps_on_card_match_cpu(cuda):
    """chip_smoke.py phase 6(a) at its smallest case: flash attention's
    gradients on the card against the oracle's autograd, then three fp32
    llama3.2-1b smoke train steps on the card against the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=cuda)
               for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = ops.flash_attention_fwd.launches
    out = ops.flash_attention(*leaves, True, 0)
    assert ops.flash_attention_fwd.launches == before + 1
    g = torch.randn(out.shape, generator=gen, device=cuda)
    grads = torch.autograd.grad(out, leaves, g)
    oracle = [x.clone().requires_grad_() for x in (q, k, v)]
    expect = ref.flash_attention_ref(*oracle, causal=True, window=0)
    expect_grads = torch.autograd.grad(expect, oracle, g)
    torch.testing.assert_close(out, expect, atol=2e-5, rtol=0)
    for got, want in zip(grads, expect_grads):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)

    cfg = get_config("llama3.2-1b", smoke=True).with_overrides(dtype="float32")
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    card = Model(cfg, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    states = [init_train_state(m, run) for m in (card, cpu)]
    steps = [build_train_step(m, run) for m in (card, cpu)]
    for i in range(3):
        batch = _torch(_batch(cfg.vocab_size, 2, 32, seed=10 + i))
        outs = [steps[j](states[j], {kk: vv.to(d) for kk, vv in batch.items()})
                for j, d in enumerate((cuda, "cpu"))]
        states = [o[0] for o in outs]
        np.testing.assert_allclose(outs[0][1]["loss"].item(), outs[1][1]["loss"].item(),
                                   **GRAD_TOL)
    for key, p in cpu.named_parameters():
        torch.testing.assert_close(card.get_parameter(key).detach().cpu(), p.detach(),
                                   **GRAD_TOL)


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only inside main)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("T", [64, 40, 5])
def test_xlstm_flop_count_of_phase_6e_matches_the_ports_products(T):
    """chip_smoke.py phase 6(e)'s count of the mLSTM chunkwise products: on
    T a whole number of chunks (or one chunk shorter than the configured
    size), torch's FLOP counter over the port's ``mlstm_chunkwise`` reads the
    count plus the masked pairs, which the port multiplies and the count
    leaves out."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import xlstm as tx

    cs = _chip_smoke()
    cfg = get_config("xlstm-1.3b", smoke=True)
    B, H, K = 2, cfg.num_heads, min(cfg.xlstm.chunk, T)
    dh = int(cfg.xlstm.proj_factor_m * cfg.d_model) // H
    dqk = dh // 2
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(B, T, H, dqk, generator=gen) for _ in range(2))
    v = torch.randn(B, T, H, dh, generator=gen)
    li, lf = (torch.randn(B, T, H, generator=gen) for _ in range(2))
    with FlopCounterMode(display=False) as counter:
        tx.mlstm_chunkwise(q, k, v, li, lf, tx.mlstm_state_spec(cfg, B, "cpu"),
                           cfg.xlstm.chunk)
    masked = (T // K) * K * K - cs.mlstm_pairs(T, cfg.xlstm.chunk)
    assert counter.get_total_flops() == B * (cs.mlstm_flops(cfg, T)
                                             + 2 * H * (dqk + dh) * masked)


def test_xlstm_flop_count_of_phase_6e_at_published_width():
    """The kept pairs against a mask built pair by pair (a T with a ragged
    last chunk), and the count at phase 6(e)'s shape by hand: 4 heads, dqk
    512, dh 1024, 32 chunks of 64 keeping 2080 pairs each, 42 mLSTM layers."""
    cs = _chip_smoke()
    for T, chunk in ((21, 8), (2048, 64), (5, 8)):
        t = torch.arange(T)
        K = min(chunk, T)
        mask = (t[:, None] // K == t[None, :] // K) & (t[None, :] <= t[:, None])
        assert cs.mlstm_pairs(T, chunk) == int(mask.sum())
    cfg = get_config("xlstm-1.3b")
    per_row = 2 * 4 * (32 * 2080 * (512 + 1024) + 2048 * (2 * 512 * 1024 + 512))
    assert cs.mlstm_flops(cfg, 2048) == per_row == 18_006_147_072
    total, mlstm = cs.xlstm_step_flops(cfg, 1_843_460_432, 4, 2048)
    assert mlstm == 3 * 4 * 42 * per_row
    assert total == 6 * 1_843_460_432 * 4 * 2048 + mlstm


@pytest.mark.parametrize("wrong", [None, 0.5, -1.0])
def test_gradient_slope_of_phase_6e_holds_the_gradient(monkeypatch, wrong):
    """chip_smoke.py phase 6(e)'s gradient check on xlstm-1.3b's smoke config
    in fp32: the port's gradient predicts the loss's change along it within
    the tolerance of XLSTM_SLOPE; a gradient at half its size or of the wrong
    sign (the gradient function scaled) reads twice or minus the change."""
    from repro_torch.launch import steps

    cs = _chip_smoke()
    cfg = get_config("xlstm-1.3b", smoke=True).with_overrides(dtype="float32")
    model = Model(cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(0))
    batch = _torch(_batch(cfg.vocab_size, 1, 64, seed=7))
    if wrong is not None:
        real = steps.grad_fn

        def scaled(model_, n=1):
            fn = real(model_, n)

            def call(b):
                loss, metrics, grads = fn(b)
                return loss, metrics, {k: wrong * g for k, g in grads.items()}
            return call
        monkeypatch.setattr(steps, "grad_fn", scaled)
    _, _, change, tol = cs.XLSTM_SLOPE
    [(measured, predicted)] = cs.gradient_slope(model, batch, [change])
    ratio = measured / predicted
    if wrong is None:
        assert abs(ratio - 1) < tol, ratio
    else:
        np.testing.assert_allclose(ratio, 1 / wrong, rtol=tol)


def test_run_config_is_the_references():
    """The port's RunConfig is a copy: the trainer reads the same fields with
    the same defaults."""
    from dataclasses import asdict

    assert asdict(RunConfig()) == asdict(JaxRunConfig())
