"""The port's MoE and MLA training against the JAX package: deepseek-v2-236b
(softmax router, two shared experts) and deepseek-v3-671b (sigmoid router
renormalised over the chosen experts, the multi-token-prediction head) at
smoke width in fp32.  The loss and every gradient (router, routed and
shared experts, the dense lead layer, every MLA projection, v3's ``mtp.*``)
against ``jax.grad``, at the smoke capacity factor and at 0.5 (choices
drop in every MoE call, and a drop that differed would move a gradient); two
microbatches against the reference's ``_grad_fn``; remat against none; and
``train()`` against JAX's ``train()`` from one initial state.  Then
``chip_smoke.py``'s launch count of a step with dense lead layers and an MTP
head, and its phase 6(g) microbatch check at smoke width.

The parameters are JAX's ``Model.init`` draws with the MLA up-projections
(``w_uq``, ``w_uk``, ``w_uv``, each ``[rank, heads, d]``) rescaled from the
reference's fan-in, the heads axis (4 at smoke width), to the rank they
contract over (32 or 48): :func:`conditioned`.  At the draws as they are,
the attention scores have a standard deviation near 8 and the gradients
are finer than fp32 can resolve: a relative change of 1e-7 in
``embed.table`` moves them by 10 (v2) and 86 (v3) times this file's
tolerance, and JAX's jitted and op-by-op gradients of the same loss differ
by 3 and 10 times it.  Rescaled, those readings are 0.1-0.3, as llama's are
at its own draws.  Every comparison is between the two frameworks on the
same parameters."""

import dataclasses
import math

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
from repro_torch.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import build_train_step, grad_fn, init_train_state  # noqa: E402
from repro_torch.models import Model, layer_plan  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")
# fp32 on both sides: summation order only (tests/test_torch_train.py's).
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
UP_PROJECTIONS = ("w_uq", "w_uk", "w_uv")


def conditioned(tree):
    """The JAX parameter tree with each MLA up-projection ``[..., rank,
    heads, d]`` scaled by sqrt(heads / rank): drawn at 1 / sqrt(rank), its
    contraction's fan-in, in place of 1 / sqrt(heads)."""
    if isinstance(tree, dict):
        return {k: (v * math.sqrt(v.shape[-2] / v.shape[-3]) if k in UP_PROJECTIONS
                    else conditioned(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [conditioned(v) for v in tree]
    return tree


def _cfgs(arch, capacity_factor=None, **overrides):
    jcfg = jax_config(arch, smoke=True).with_overrides(dtype="float32", **overrides)
    tcfg = get_config(arch, smoke=True).with_overrides(dtype="float32", **overrides)
    if capacity_factor is not None:
        jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe,
                                                           capacity_factor=capacity_factor))
        tcfg = tcfg.with_overrides(moe=dataclasses.replace(tcfg.moe,
                                                           capacity_factor=capacity_factor))
    return jcfg, tcfg


def _models(arch, capacity_factor=None, **overrides):
    jcfg, tcfg = _cfgs(arch, capacity_factor, **overrides)
    jm = JaxModel(jcfg)
    jp = conditioned(jax.device_get(jm.init(jax.random.PRNGKey(0))))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jp))
    return jm, jp, tm


def _batch(vocab, B, T, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _close(out, expect, **tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect), **tol)


def _routed_leaves(arch):
    """Keys that the comparison must cover: the router, the routed and
    shared experts, the lead layer's dense FFN and MLA, and v3's MTP head."""
    keys = {"blocks.b0.ffn.router", "blocks.b0.ffn.wi", "blocks.b0.ffn.wo",
            "blocks.b0.ffn.shared.wi", "blocks.b0.ffn.shared.wo", "lead.0.ffn.wi",
            "lead.0.ffn.wo"}
    keys |= {f"{layer}.attn.{w}" for layer in ("lead.0", "blocks.b0")
             for w in ("w_dq", "q_norm.scale", "w_uq", "w_dkv", "kv_norm.scale", "w_uk",
                       "w_uv", "w_kr", "wo")}
    if arch == "deepseek-v3-671b":
        keys |= {"mtp.proj", "mtp.norm.scale", "mtp.block.attn.w_uk", "mtp.block.ffn.wi"}
    return keys


@pytest.mark.parametrize("arch,capacity_factor", [(ARCHS[0], None), (ARCHS[1], None),
                                                   (ARCHS[1], 0.5)])
def test_loss_and_every_grad_match_jax(arch, capacity_factor, monkeypatch):
    """At the smoke capacity factor (2.0) and at 0.5, where every MoE
    layer's call (the forward's and remat's recompute) drops choices, as
    the reference's scatter does."""
    jm, jp, tm = _models(arch, capacity_factor)
    dropped = []
    real_route = moe_mod._route

    def route(p, xg, m, C):
        gates, slot, aux = real_route(p, xg, m, C)
        dropped.append(int((slot == m.num_experts * C).sum()))
        return gates, slot, aux

    monkeypatch.setattr(moe_mod, "_route", route)
    batch = _batch(jm.cfg.vocab_size, 2, 32, seed=1)
    (jloss, jmetrics), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, _jax(batch))
    loss, metrics, grads = grad_fn(tm, 1)(_torch(batch))
    want = {"ce", "aux", "loss"} | ({"mtp_ce"} if arch == "deepseek-v3-671b" else set())
    assert set(metrics) == set(jmetrics) == want
    for key in want:
        _close(metrics[key].item(), float(jmetrics[key]), err_msg=key, **GRAD_TOL)
    _close(loss.item(), float(jloss), **GRAD_TOL)
    expect = params_from_jax(jax.device_get(jg))
    assert set(grads) == set(expect) == {n for n, _ in tm.named_parameters()}
    assert _routed_leaves(arch) <= set(grads)
    for key, g in grads.items():
        _close(g.numpy(), expect[key].numpy(), err_msg=key, **GRAD_TOL)
        assert g.abs().sum() > 0, key
    assert len(dropped) == 2 * layer_plan(tm.cfg).n_scan
    if capacity_factor == 0.5:
        assert all(dropped)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_grads_match_jax_grad_fn(arch):
    """Two microbatches, each its own routing and capacity, summed in fp32."""
    jm, jp, tm = _models(arch)
    batch = _batch(jm.cfg.vocab_size, 4, 16, seed=2)
    with set_mesh(make_mesh((1, 1), ("data", "model"))):
        (jloss, _), jg = jax.jit(jax_grad_fn(jm.loss, 2))(jp, _jax(batch))
    loss, _, grads = grad_fn(tm, 2)(_torch(batch))
    _close(loss.item(), float(jloss), **GRAD_TOL)
    expect = params_from_jax(jax.device_get(jg))
    assert set(grads) == set(expect)
    for key, g in grads.items():
        assert g.dtype == torch.float32
        _close(g.numpy(), expect[key].numpy(), err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    """The MoE super-blocks' recompute routes its tokens again: the same
    choices, drops and gradients as without remat."""
    _, _, tm = _models(arch, capacity_factor=0.5)
    _, _, plain = _models(arch, capacity_factor=0.5, remat="none")
    batch = _torch(_batch(256, 2, 24, seed=3))
    l1, m1, g1 = grad_fn(tm, 1)(batch)
    l2, m2, g2 = grad_fn(plain, 1)(batch)
    assert l1.item() == l2.item() and m1["aux"].item() == m2["aux"].item()
    for key in g1:
        torch.testing.assert_close(g1[key], g2[key], atol=1e-7, rtol=1e-6)


def test_moe_groups_stay_one_on_one_device():
    """JAX's train() runs a data axis of 1: MoEConfig.groups stays 1, and so
    it does in the port's config."""
    for arch in ARCHS:
        assert get_config(arch).moe.groups == jax_config(arch).moe.groups == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_curve_matches_jax_train(tmp_path, monkeypatch, arch):
    """``train()``, 3 fp32 steps of 2 microbatches from one initial state
    (JAX's ``init_train_state`` with the conditioned up-projections, written
    at step 0 and resumed by both): losses, grad-norms and every final
    weight, the router and the experts among them."""
    steps = 3
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=steps,
              checkpoint_every=10 ** 9, microbatches=2)
    monkeypatch.setattr(jax_train_mod, "get_config",
                        lambda a, smoke: jax_config(a, smoke).with_overrides(dtype="float32"))
    monkeypatch.setattr(train_mod, "get_config",
                        lambda a, smoke: get_config(a, smoke).with_overrides(dtype="float32"))
    jrun = JaxRunConfig(checkpoint_dir=str(tmp_path / "jax"), **kw)
    run = RunConfig(checkpoint_dir=str(tmp_path / "port"), **kw)
    init = jax.device_get(jax_init_train_state(JaxModel(jax_train_mod.get_config(arch, True)),
                                               jrun, jax.random.PRNGKey(jrun.seed)))
    init["params"] = conditioned(init["params"])
    for directory in (jrun.checkpoint_dir, run.checkpoint_dir):
        jax_save_checkpoint(directory, 0, init)
    shape = dict(seq_len=24, global_batch=4, kind="train")
    expect = jax_train_mod.train(arch, steps=steps, run=jrun, log_every=1, resume=True,
                                 shape=JaxShapeConfig("t", **shape))
    out = train_mod.train(arch, steps=steps, run=run, log_every=1, resume=True,
                          shape=ShapeConfig("t", **shape), device="cpu")
    for key in ("loss", "grad_norm"):
        _close([h[key] for h in out["history"]], [h[key] for h in expect["history"]],
               rtol=1e-4, atol=0)
    want = params_from_jax(jax.device_get(expect["final_state"]["params"]))
    got = out["final_state"]["params"]
    assert set(got) == set(want)
    for key, p in got.items():
        _close(p.detach().numpy(), want[key].numpy(), err_msg=key, **GRAD_TOL)
    start = params_from_jax(init["params"])
    for key in ("blocks.b0.ffn.router", "blocks.b0.ffn.wi", "blocks.b0.ffn.wo"):
        assert not torch.equal(got[key].detach(), start[key]), key


# ------------------------------------------------ chip_smoke.py phase 6 --
def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only inside main)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_expected_launches_count_lead_layers_and_the_mtp_head(arch, monkeypatch):
    """chip_smoke.py's count of one train step's flash calls: the dense lead
    layers (no remat) and v3's MTP block once each way, the stacked MoE
    layers forward twice (remat's recompute) and backward once; read off
    the calls that a CPU step makes of ``ops``' entries."""
    cs = _chip_smoke()
    cfg = get_config(arch, smoke=True).with_overrides(dtype="float32")
    calls = {"flash_attention": 0, "flash_attention_bwd": 0}
    real_fwd, real_bwd = ops._flash_fwd, ops._flash_bwd

    def fwd(*a, **k):
        calls["flash_attention"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["flash_attention_bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(ops, "_flash_fwd", fwd)
    monkeypatch.setattr(ops, "_flash_bwd", bwd)
    model = Model(cfg, device="cpu")
    run = RunConfig(microbatches=2)
    step = build_train_step(model, run)
    step(init_train_state(model, run), _torch(_batch(cfg.vocab_size, 4, 16, seed=4)))
    want = cs.expected_launches(layer_plan(cfg), 2, cfg.mtp_depth)
    assert {k: want[k] for k in calls} == calls
    plan = layer_plan(cfg)
    per_mb = len(plan.lead) + 2 * plan.n_scan + cfg.mtp_depth
    assert calls["flash_attention"] == 2 * per_mb


@pytest.mark.parametrize("arch", ARCHS)
def test_phase_6g_microbatch_check_sees_a_noncausal_recompute(arch):
    """deepseek at smoke width: the microbatch through ``ops`` (the plain
    versions, on the CPU) equals the plain versions swapped in (run over
    slices of the heads); the causal mask dropped in remat's recompute alone
    exceeds phase 6(g)'s limits: its worst leaf over 3 times, its norm gap
    over 10 times."""
    cs = _chip_smoke()
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    mb = _torch(_batch(cfg.vocab_size, 2, 40, seed=5))
    plain = cs.plain_entries()
    forward = cs.forward_flash_calls(cfg)
    calls = []

    def wrong_recompute(q, k, v, causal, window, scale, lse=False):
        calls.append(None)
        return plain["_flash_fwd"](q, k, v, causal and len(calls) <= forward, window, scale,
                                   lse)

    ours = cs.microbatch_grads(model, mb)
    want = cs.microbatch_grads(model, mb, plain)
    wrong = cs.microbatch_grads(model, mb, {**plain, "_flash_fwd": wrong_recompute})
    assert len(calls) == forward + layer_plan(cfg).n_scan
    assert cs.grad_gaps(ours, want)[:3] == (0.0, 0.0, 0.0)
    gaps = cs.grad_gaps(wrong, want)
    tol = cs.DEEPSEEK_TRAIN_BF16_TOL
    assert gaps[0] == 0.0 and gaps[1] > 3 * tol["grad"] and gaps[2] > 10 * tol["norm"]


@pytest.mark.parametrize("H,K", [(8, 8), (8, 2)])
def test_plain_entries_over_head_slices_equal_the_whole(monkeypatch, H, K):
    """Phase 6(g)'s plain flash versions run over slices of whole GQA
    groups; forced to one group a slice, the output, lse and dq, dk, dv
    equal the plain versions over all heads at once."""
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    B, T, dk, dv, scale = 2, 20, 24, 16, 0.2
    monkeypatch.setattr(cs, "PLAIN_BYTES", B * (H // K) * T * T * 4)
    assert len(cs.head_slices(B, T, T, H, K)) == K
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(s, generator=gen) for s in ((B, T, H, dk), (B, T, K, dk),
                                                        (B, T, K, dv)))
    g = torch.randn((B, T, H, dv), generator=gen)
    plain = cs.plain_entries()
    out, lse = plain["_flash_fwd"](q, k, v, True, 0, scale, lse=True)
    want_out, want_lse = ref.flash_attention_lse_ref(q, k, v, causal=True, window=0,
                                                     scale=scale)
    torch.testing.assert_close(out, want_out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(plain["_flash_fwd"](q, k, v, True, 0, scale), want_out,
                               atol=1e-6, rtol=1e-6)
    got = plain["_flash_bwd"](q, k, v, out, lse, g, True, 0, scale)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=True, window=0, scale=scale)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("phase", ["DEEPSEEK_TRAIN", "INTERNVL2_TRAIN"])
def test_phases_6g_6h_rehearse_at_smoke_width_on_the_cpu(phase):
    """``chip_smoke.py``'s phases 6(g) and 6(h) end to end at smoke width on
    the CPU (no kernel launches, so none is expected): four steps through
    ``train()``, every weight matrix moved, then the microbatch check with
    its wrong recompute, which must exceed the phase's limits."""
    cs = _chip_smoke()
    arch, layers, rows, _, micro, steps, lr = getattr(cs, phase)
    tol = getattr(cs, "DEEPSEEK_TRAIN_BF16_TOL" if "deepseek" in arch
                  else "INTERNVL2_TRAIN_BF16_TOL")
    seq = 24 if arch == "internvl2-76b" else 32
    launches, attn_ms = cs.published_width_training(arch, layers, rows, seq, micro, steps, lr,
                                                    tol, "cpu", smoke=True, device="cpu")
    assert not any(launches.values()) and attn_ms is None
