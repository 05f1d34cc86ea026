"""The port's Model against the JAX Model on the same weights: prefill logits
and caches, then a teacher-forced greedy decode loop (llama3.2-1b, the
recurrentgemma-9b hybrid, the MLA + MoE deepseek-v2-236b and xlstm-1.3b,
smoke widths, fp32), the loss of both deepseek archs (ce, the MoE aux,
DeepSeek-V3's mtp_ce) and of xlstm-1.3b, what the port still refuses, and
every arch's parameter tree (the frontends' models are held against JAX in
tests/test_torch_frontends.py)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import param_count as jax_param_count  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model, model_specs, param_count  # noqa: E402

DENSE = ("llama3.2-1b", "llama3-8b", "glm4-9b", "codeqwen1.5-7b")
HYBRID = ("recurrentgemma-9b",)
MOE = ("deepseek-v2-236b", "deepseek-v3-671b")
SSM = ("xlstm-1.3b",)
FRONTEND = ("hubert-xlarge", "internvl2-76b")


def _models(arch):
    jcfg = jax_config(arch, smoke=True).with_overrides(dtype="float32")
    tcfg = get_config(arch, smoke=True).with_overrides(dtype="float32")
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jm, jp, tm


def _tokens(vocab, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _close(out, expect, atol, rtol):
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=atol, rtol=rtol)


def test_llama_prefill_then_teacher_forced_decode():
    jm, jp, tm = _models("llama3.2-1b")
    B, T, steps = 2, 24, 8
    max_len = T + steps
    tokens = _tokens(jm.cfg.vocab_size, B, T)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)

    jl, jc = jprefill(jp, {"tokens": jnp.asarray(tokens)}, max_len)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens).long()}, max_len)
    assert tuple(tl.shape) == (B, 1, jm.cfg.vocab_size)
    _close(tl, jl, atol=2e-4, rtol=1e-3)
    jb, tb = jc["blocks"]["b0"], tc["blocks"]["b0"]
    _close(tb.k, jb.k, atol=1e-4, rtol=1e-3)
    _close(tb.v, jb.v, atol=1e-4, rtol=1e-3)
    assert tb.length == T and np.all(np.asarray(jb.length) == T)

    for step in range(steps):
        # Both models are fed JAX's greedy token.
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok).long())
        _close(tl, jl, atol=5e-3, rtol=1e-2)
        assert tc["blocks"]["b0"].length == T + step + 1
        # Where JAX's top-2 margin exceeds the tolerance, the argmax agrees.
        jlast, tlast = np.asarray(jl[:, -1]), tl[:, -1].numpy()
        top2 = np.sort(jlast, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 5e-3 + 1e-2 * np.abs(top2[:, 1])
        np.testing.assert_array_equal(tlast.argmax(-1)[clear], jlast.argmax(-1)[clear])


@pytest.mark.parametrize("arch", DENSE[1:])
def test_dense_prefill_matches(arch):
    """The other dense GQA archs: untied heads, MHA (K == H), other RoPE bases."""
    jm, jp, tm = _models(arch)
    tokens = _tokens(jm.cfg.vocab_size, 2, 16, seed=1)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 20)
    tl, _ = tm.prefill({"tokens": torch.from_numpy(tokens).long()}, 20)
    _close(tl, jl, atol=2e-4, rtol=1e-3)


def test_recurrentgemma_prefill_then_teacher_forced_decode():
    """24 prompt tokens past the smoke window of 16, then 8 decode steps that
    wrap the ring buffer; the rec caches (h, conv) and the KV ring match too."""
    jm, jp, tm = _models("recurrentgemma-9b")
    assert jm.cfg.window == 16 and tm.plan.pattern == ("rec", "rec", "attn")
    B, T, steps = 2, 24, 8
    max_len = T + steps
    tokens = _tokens(jm.cfg.vocab_size, B, T, seed=2)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)

    def caches_close(tc, jc, atol, rtol):
        for key in ("b0", "b1"):
            for f in ("h", "conv"):
                _close(getattr(tc["blocks"][key], f), getattr(jc["blocks"][key], f),
                       atol, rtol)
        for f in ("k", "v"):
            _close(getattr(tc["blocks"]["b2"], f), getattr(jc["blocks"]["b2"], f), atol, rtol)
        for tt, jt in zip(tc["tail"], jc["tail"], strict=True):
            _close(tt.h, jt.h, atol, rtol)
            _close(tt.conv, jt.conv, atol, rtol)

    jl, jc = jprefill(jp, {"tokens": jnp.asarray(tokens)}, max_len)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens).long()}, max_len)
    _close(tl, jl, atol=2e-4, rtol=1e-3)
    caches_close(tc, jc, atol=2e-4, rtol=1e-3)
    assert tc["blocks"]["b2"].k.shape[2] == 16  # S = window: [n, B, S, K, hd]
    assert tc["blocks"]["b2"].length == T

    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok).long())
        _close(tl, jl, atol=5e-3, rtol=1e-2)
        assert tc["blocks"]["b2"].length == T + step + 1
    caches_close(tc, jc, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("arch", MOE)
def test_deepseek_prefill_then_teacher_forced_decode(arch):
    """MLA with its latent caches, a dense lead layer and MoE layers (v2's
    softmax router and 2 shared experts, v3's sigmoid router and 1).  Each
    step is held to JAX's same step, not to the forward: capacity is per
    call, so a prefill may drop tokens that decode (C >= 8) never drops."""
    jm, jp, tm = _models(arch)
    assert tm.plan.lead == ("attn_dense",) and tm.plan.n_scan == jm.cfg.num_layers - 1
    B, T, steps = 2, 20, 6
    max_len = T + steps
    tokens = _tokens(jm.cfg.vocab_size, B, T, seed=3)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)

    def caches_close(tc, jc, atol, rtol):
        for tt, jt in ((tc["lead"][0], jc["lead"][0]), (tc["blocks"]["b0"], jc["blocks"]["b0"])):
            _close(tt.c_kv, jt.c_kv, atol, rtol)
            _close(tt.k_rope, jt.k_rope, atol, rtol)

    jl, jc = jprefill(jp, {"tokens": jnp.asarray(tokens)}, max_len)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens).long()}, max_len)
    _close(tl, jl, atol=2e-4, rtol=1e-3)
    caches_close(tc, jc, atol=2e-4, rtol=1e-3)
    assert tc["lead"][0].length == tc["blocks"]["b0"].length == T

    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok).long())
        _close(tl, jl, atol=5e-3, rtol=1e-2)
        assert tc["lead"][0].length == tc["blocks"]["b0"].length == T + step + 1
    caches_close(tc, jc, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("arch", MOE)
def test_deepseek_loss_matches(arch):
    """``Model.loss``: cross-entropy, the MoE load-balance aux (weighted into
    the total) and, for deepseek-v3, the multi-token-prediction loss."""
    jm, jp, tm = _models(arch)
    tokens = _tokens(jm.cfg.vocab_size, 2, 16, seed=4)
    labels = np.roll(tokens, -1, axis=1)
    _, jmet = jm.loss(jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    _, tmet = tm.loss({"tokens": torch.from_numpy(tokens).long(),
                       "labels": torch.from_numpy(labels).long()})
    want = {"ce", "aux", "loss"} | ({"mtp_ce"} if arch == "deepseek-v3-671b" else set())
    assert set(tmet) == set(jmet) == want
    for key in want:
        _close(tmet[key].detach(), jmet[key], atol=1e-5, rtol=1e-4)


def test_xlstm_prefill_then_teacher_forced_decode():
    """A 21-token prompt (no multiple of the smoke chunk of 8: the state
    passes the padding unchanged), then 8 decode steps; every state field
    of both block kinds (c, n, m, and h for the sLSTM) matches JAX's."""
    jm, jp, tm = _models("xlstm-1.3b")
    assert tm.plan.pattern == ("mlstm", "slstm") and jm.cfg.xlstm.chunk == 8
    B, T, steps = 2, 21, 8
    max_len = T + steps
    tokens = _tokens(jm.cfg.vocab_size, B, T, seed=5)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)

    def caches_close(tc, jc, atol, rtol):
        for key, fields in (("b0", ("c", "n", "m")), ("b1", ("c", "n", "m", "h"))):
            tt, jt = tc["blocks"][key], jc["blocks"][key]
            assert tt._fields == jt._fields
            for f in fields:
                _close(getattr(tt, f), getattr(jt, f), atol, rtol)

    jl, jc = jprefill(jp, {"tokens": jnp.asarray(tokens)}, max_len)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens).long()}, max_len)
    _close(tl, jl, atol=2e-4, rtol=1e-3)
    caches_close(tc, jc, atol=2e-4, rtol=1e-3)
    assert tuple(tc["blocks"]["b0"].c.shape) == (2, B, 4, 16, 32)

    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok).long())
        _close(tl, jl, atol=5e-3, rtol=1e-2)
    caches_close(tc, jc, atol=5e-3, rtol=1e-2)


def test_xlstm_loss_matches():
    jm, jp, tm = _models("xlstm-1.3b")
    tokens = _tokens(jm.cfg.vocab_size, 2, 20, seed=6)
    labels = np.roll(tokens, -1, axis=1)
    _, jmet = jm.loss(jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    _, tmet = tm.loss({"tokens": torch.from_numpy(tokens).long(),
                       "labels": torch.from_numpy(labels).long()})
    assert set(tmet) == set(jmet) == {"ce", "loss"}
    for key in ("ce", "loss"):
        _close(tmet[key].detach(), jmet[key], atol=1e-5, rtol=1e-4)


def test_every_arch_is_supported():
    assert set(ARCHS) == set(DENSE + HYBRID + MOE + SSM + FRONTEND)
    for arch in ARCHS:
        model_specs(get_config(arch, smoke=True))


def _unknown_block_kind():
    return get_config("llama3.2-1b", smoke=True).with_overrides(block_pattern=("attn", "conv"))


def _unknown_expert_layout():
    cfg = get_config("deepseek-v2-236b", smoke=True)
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, expert_sharding="ep3d"))


@pytest.mark.parametrize("make_cfg", [_unknown_block_kind, _unknown_expert_layout])
def test_other_archs_are_refused(make_cfg):
    """What the port still refuses: a block kind it does not know, and an
    expert layout that is none of the reference's four (``fsdp_d``,
    ``fsdp_f``, ``ep2d``, ``ep_a2a``)."""
    with pytest.raises(NotImplementedError, match="not yet"):
        model_specs(make_cfg())


def test_hybrid_bf16_tree_loads_one_to_one():
    """JAX's bf16 recurrentgemma tree (blocks.b0-b2, tail.0-1, fp32 ``lam``)
    loads with strict keys and keeps every dtype."""
    jp = JaxModel(jax_config("recurrentgemma-9b", smoke=True)).init(jax.random.PRNGKey(1))
    sd = params_from_jax(jax.device_get(jp))
    tm = Model(get_config("recurrentgemma-9b", smoke=True), device="cpu")
    tm.load_state_dict(sd)
    got = tm.state_dict()
    assert set(got) == set(sd)
    assert {"blocks.b0.rec.w_a", "blocks.b2.attn.wq", "tail.0.rec.lam",
            "tail.1.ffn.wo"} <= set(got)
    for key, want in sd.items():
        assert got[key].dtype == want.dtype, key
        assert torch.equal(got[key], want), key
    assert got["tail.1.rec.lam"].dtype == torch.float32
    assert got["blocks.b0.rec.w_a"].dtype == torch.bfloat16


def test_moe_bf16_tree_loads_one_to_one():
    """JAX's bf16 deepseek-v3 tree (lead.0, blocks.b0 stacked, mtp, an
    untied unembed) loads with strict keys; the router stays fp32."""
    jp = JaxModel(jax_config("deepseek-v3-671b", smoke=True)).init(jax.random.PRNGKey(2))
    sd = params_from_jax(jax.device_get(jp))
    tm = Model(get_config("deepseek-v3-671b", smoke=True), device="cpu")
    assert tm.get_parameter("blocks.b0.ffn.router").dtype == torch.float32  # at init too
    tm.load_state_dict(sd)
    got = tm.state_dict()
    assert set(got) == set(sd)
    assert {"lead.0.attn.w_dkv", "lead.0.ffn.wi", "blocks.b0.ffn.shared.wi",
            "mtp.proj", "mtp.block.attn.w_uq", "unembed.w"} <= set(got)
    for key, want in sd.items():
        assert got[key].dtype == want.dtype, key
        assert torch.equal(got[key], want), key
    assert got["blocks.b0.ffn.router"].dtype == torch.float32
    assert got["blocks.b0.ffn.wi"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE + HYBRID + MOE + SSM + FRONTEND)
def test_param_tree_matches_jax(arch):
    """Same parameter count at the published widths; same state_dict keys and
    shapes at smoke width."""
    assert param_count(model_specs(get_config(arch))) == jax_param_count(
        JaxModel(jax_config(arch)).specs())
    jcfg = jax_config(arch, smoke=True)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   JaxModel(jcfg).param_shapes())
    expect = {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}
    got = {k: tuple(v.shape) for k, v in Model(get_config(arch, smoke=True),
                                               device="cpu").state_dict().items()}
    assert got == expect
