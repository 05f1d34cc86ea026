"""The port's shared layers against ``repro.models.layers`` on the same inputs."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

RNG = np.random.default_rng(0)


def _pair(*shape, scale=1.0):
    a = (scale * RNG.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    jx, tx = _pair(2, 5, 64, scale=3.0)
    js, ts = _pair(64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    expect = jl.rmsnorm({"scale": js.astype(jdt)}, jx.astype(jdt))
    out = tl.rmsnorm({"scale": ts.to(tdt)}, tx.to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect, np.float32),
                               atol=1e-5 if dtype == "float32" else 2e-2, rtol=1e-5)


@pytest.mark.parametrize("act,width", [("swiglu", 2 * 96), ("gelu", 96)])
def test_mlp(act, width):
    jx, tx = _pair(2, 7, 32)
    jwi, twi = _pair(32, width, scale=0.2)
    jwo, two = _pair(96, 32, scale=0.1)
    expect = jl.mlp({"wi": jwi, "wo": jwo}, jx, act)
    out = tl.mlp({"wi": twi, "wo": two}, tx, act)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-5, rtol=1e-5)


def test_mlp_spec_matches():
    for act in ("swiglu", "gelu"):
        j = jl.mlp_spec(32, 96, act)
        t = tl.mlp_spec(32, 96, act)
        assert {k: v.shape for k, v in j.items()} == {k: v.shape for k, v in t.items()}


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_rope(positions):
    B, T, H, d = 2, 9, 3, 16
    jx, tx = _pair(B, T, H, d)
    if positions == "prefill":
        pos = np.arange(T, dtype=np.int32)[None, :]
    else:  # one token per sequence at a shared absolute position
        jx, tx = jx[:, :1], tx[:, :1]
        pos = np.full((B, 1), 37, np.int32)
    expect = jl.rope(jx, jnp.asarray(pos), 500000.0)
    out = tl.rope(tx, torch.from_numpy(pos), 500000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-5, rtol=1e-5)


def test_embed_and_unembed():
    jt, tt = _pair(50, 16)
    tokens = RNG.integers(0, 50, (3, 6))
    expect = jl.embed({"table": jt}, jnp.asarray(tokens, jnp.int32))
    out = tl.embed({"table": tt}, torch.from_numpy(tokens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(expect))
    jw, tw = _pair(16, 50)
    np.testing.assert_allclose(tl.unembed({"w": tw}, out).numpy(),
                               np.asarray(jl.unembed({"w": jw}, expect)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    jx, tx = _pair(2, 5, 64, scale=3.0)
    js, ts = _pair(64)
    jb, tb = _pair(64, scale=0.5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    expect = jl.layernorm({"scale": js.astype(jdt), "bias": jb.astype(jdt)}, jx.astype(jdt))
    out = tl.layernorm({"scale": ts.to(tdt), "bias": tb.to(tdt)}, tx.to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect, np.float32),
                               atol=1e-5 if dtype == "float32" else 3e-2, rtol=1e-5)
    spec = tl.layernorm_spec(64)
    assert spec["scale"].init == "ones" and spec["bias"].init == "zeros"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent(dtype, masked):
    """fp32 logsumexp minus the gold logit, meaned over the mask; the gather
    gives the reference's one-hot contraction's value."""
    jlog, tlog = _pair(3, 7, 50, scale=4.0)
    labels = RNG.integers(0, 50, (3, 7))
    mask = (RNG.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    expect = jl.softmax_xent(jlog.astype(jdt), jnp.asarray(labels, jnp.int32),
                             None if mask is None else jnp.asarray(mask))
    out = tl.softmax_xent(tlog.to(tdt), torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == ()
    np.testing.assert_allclose(out.item(), float(expect), rtol=1e-6)


def test_softmax_xent_empty_mask_is_zero():
    logits = torch.zeros((2, 3, 5))
    out = tl.softmax_xent(logits, torch.zeros((2, 3), dtype=torch.long), torch.zeros((2, 3)))
    assert out.item() == 0.0
