"""The port's GQA prefill/decode against ``repro.models.attention``: outputs,
cache contents and cache length, with and without a ring-buffered window."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models.specs import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

CASES = [
    # window, T, max_len, decode steps
    (0, 12, 16, 6),   # pad T < S; decode runs past S-1 (slot clamps at S-1)
    (0, 16, 16, 2),   # T == S
    (8, 12, 16, 6),   # T >= S: roll into the ring, decode wraps it
    (8, 5, 16, 6),    # T < S: pad, decode wraps the ring at step 3
]


def _setup(window, arch="llama3.2-1b", **over):
    over = dict(dtype="float32", window=window, **over)
    jcfg = jax_config(arch, smoke=True).with_overrides(**over)
    tcfg = get_config(arch, smoke=True).with_overrides(**over)
    jp = init_params(ja.gqa_spec(jcfg, jnp.float32), jax.random.PRNGKey(3))
    tp = params_from_jax(jax.device_get(jp))
    return jcfg, tcfg, jp, tp


def _close(a, b, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _prefill_then_decode(jcfg, tcfg, jp, tp, T, max_len, steps, seed):
    B, D = 2, jcfg.d_model
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)

    jy, jc = ja.gqa_prefill(jp, jnp.asarray(x), jcfg, max_len)
    cache = ta.gqa_cache_spec(tcfg, B, max_len, torch.float32, torch.device("cpu"))
    ty, tc = ta.gqa_prefill(tp, torch.from_numpy(x), tcfg, cache)
    _close(ty.numpy(), jy)
    _close(tc.k.numpy(), jc.k)
    _close(tc.v.numpy(), jc.v)
    assert tc.length == int(jc.length) == T
    assert tc.k.data_ptr() == cache.k.data_ptr()  # filled in place

    for step in range(steps):
        xd = rng.standard_normal((B, 1, D)).astype(np.float32)
        jy, jc = ja.gqa_decode(jp, jnp.asarray(xd), jcfg, jc)
        ty, tc = ta.gqa_decode(tp, torch.from_numpy(xd), tcfg, tc)
        _close(ty.numpy(), jy)
        _close(tc.k.numpy(), jc.k)
        _close(tc.v.numpy(), jc.v)
        assert tc.length == int(jc.length) == T + step + 1


@pytest.mark.parametrize("window,T,max_len,steps", CASES)
def test_gqa_prefill_and_decode_match(window, T, max_len, steps):
    _prefill_then_decode(*_setup(window), T, max_len, steps, seed=window + T)


def test_windowed_mqa_head_dim_256_matches():
    """recurrentgemma's attention: one KV head under 4 query heads, head dim
    256, a prompt of 24 past a window of 16, decode wrapping the ring."""
    jcfg, tcfg, jp, tp = _setup(16, "recurrentgemma-9b", head_dim=256)
    assert (tcfg.num_kv_heads, tcfg.resolved_head_dim) == (1, 256)
    _prefill_then_decode(jcfg, tcfg, jp, tp, T=24, max_len=32, steps=10, seed=7)


def test_decode_attention_per_sequence_lengths():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    lengths = np.array([1, 6, 10], np.int32)
    for window in (0, 4):
        expect = ja.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lengths), window=window)
        out = ta.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(lengths),
                                  window=window)
        _close(out.numpy(), expect)


def test_cache_shape_matches_jax_spec():
    for window in (0, 8):
        jcfg, tcfg, _, _ = _setup(window)
        spec = ja.gqa_cache_spec(jcfg, 2, 16, jnp.float32)
        c = ta.gqa_cache_spec(tcfg, 2, 16, torch.float32, torch.device("cpu"))
        assert tuple(c.k.shape) == spec.k.shape and tuple(c.v.shape) == spec.v.shape
        assert c.length == 0 and not c.k.any()


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_attention_train_matches_jax(window):
    """Train mode: the port's flash path (its plain version on the CPU)
    against the reference's ``online_attention`` path, output and grads of x
    and of every projection."""
    jcfg, tcfg, jp, tp = _setup(window)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)

    def fwd_bwd(p, x_):
        y, vjp = jax.vjp(lambda p_, xx: ja.gqa_attention(p_, xx, jcfg), p, x_)
        return y, vjp(jnp.asarray(w))

    jy, (jgp, jgx) = jax.jit(fwd_bwd)(jp, jnp.asarray(x))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = ta.gqa_attention(params, tx, tcfg)
    _close(y.detach().numpy(), jy)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), [tx, *params.values()])
    _close(grads[0].numpy(), jgx)
    want = params_from_jax(jax.device_get(jgp))
    for key, g in zip(params, grads[1:]):
        _close(g.numpy(), want[key].numpy())
