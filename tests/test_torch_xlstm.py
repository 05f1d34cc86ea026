"""The port's xLSTM blocks against ``repro.models.xlstm`` on the same numpy
inputs: the chunkwise mLSTM (fp32 and bf16, a prompt that is and one that is
not a multiple of the chunk, from a fresh and from a carried state, with the
state it returns), the mLSTM step, the sLSTM cell, both blocks with and
without a state and their decode steps on converted parameters, and the
port's chunkwise form against its own sequential oracle."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.specs import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

# |port - JAX| <= TOL + RTOL |JAX|: fp32 differs in summation order only
# (tests/test_kernels.py's 2e-5); bf16 rounds the decay weights, the carried
# state and the products' sums to bf16 at the same places on both sides, but
# the two frameworks' bf16 matmuls may sum in another order, and a sum that
# rounds to the other side moves by one bf16 ulp, up to 2^-7 of its value
# (0.8 %), which the division by |n·q| carries into h at any magnitude
# (tests/test_kernels.py's 2e-2, absolute and relative).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# B, H, dqk, dh, chunk
SHAPE = (2, 2, 8, 16, 8)


def _pair(a: np.ndarray, dtype: str):
    """The same values for both frameworks: fp32 draws rounded once to bf16."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _mlstm_inputs(T: int, carried: bool, seed=0):
    """q, k, v, log_i, log_f and a state as numpy arrays: a fresh state (m at
    -1e30) or a carried one."""
    B, H, dqk, dh, _ = SHAPE
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f32(B, T, H, dqk), f32(B, T, H, dqk) / math.sqrt(dqk), f32(B, T, H, dh)
    log_i = f32(B, T, H)
    log_f = -np.log1p(np.exp(-(f32(B, T, H) + 3.0))).astype(np.float32)
    if carried:
        state = (0.5 * f32(B, H, dqk, dh), 0.5 * f32(B, H, dqk), f32(B, H))
    else:
        state = (np.zeros((B, H, dqk, dh), np.float32), np.zeros((B, H, dqk), np.float32),
                 np.full((B, H), -1e30, np.float32))
    return (q, k, v, log_i, log_f), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [32, 29])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_matches_jax(dtype, T, carried):
    (q, k, v, li, lf), state = _mlstm_inputs(T, carried)
    pairs = [_pair(a, dtype) for a in (q, k, v)] + [_pair(a, "float32") for a in (li, lf)]
    tstate = tx.MLSTMState(*(torch.from_numpy(s) for s in state))
    jstate = jx.MLSTMState(*(jnp.asarray(s) for s in state))
    chunk = SHAPE[-1]
    h, new = tx.mlstm_chunkwise(*(t for t, _ in pairs), tstate, chunk)
    jh, jnew = jx.mlstm_chunkwise(*(j for _, j in pairs), jstate, chunk)
    assert h.dtype == torch.float32 and tuple(h.shape) == jh.shape
    _close(h, jh, TOL[dtype], RTOL[dtype])
    for got, want in zip(new, jnew):
        _close(got, want, TOL[dtype], RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_step_matches_jax(dtype):
    (q, k, v, li, lf), state = _mlstm_inputs(1, True, seed=1)
    pairs = [_pair(a[:, 0], dtype) for a in (q, k, v)] + [
        _pair(a[:, 0], "float32") for a in (li, lf)]
    h, new = tx.mlstm_step(*(t for t, _ in pairs),
                           tx.MLSTMState(*(torch.from_numpy(s) for s in state)))
    jh, jnew = jx.mlstm_step(*(j for _, j in pairs),
                             jx.MLSTMState(*(jnp.asarray(s) for s in state)))
    _close(h, jh, 2e-5, rtol=1e-5)
    for got, want in zip(new, jnew):
        _close(got, want, 2e-5, rtol=1e-5)


def _cfgs():
    return (get_config("xlstm-1.3b", smoke=True).with_overrides(dtype="float32"),
            jax_config("xlstm-1.3b", smoke=True).with_overrides(dtype="float32"))


def _params(spec_fn, seed):
    """JAX's fp32 parameters for one block and the same as torch tensors."""
    _, jcfg = _cfgs()
    jp = init_params(spec_fn(jcfg, jnp.float32), jax.random.PRNGKey(seed))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return tp, jp


def _slstm_state(B, D, seed):
    rng = np.random.default_rng(seed)
    c, h, m = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(3))
    n = (1.0 + rng.random((B, D))).astype(np.float32)
    return c, n, m, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_cell_matches_jax(dtype):
    tcfg, jcfg = _cfgs()
    B, D = 3, tcfg.d_model
    rng = np.random.default_rng(2)
    r = (0.02 * rng.standard_normal((4, tcfg.num_heads, D // tcfg.num_heads,
                                     D // tcfg.num_heads))).astype(np.float32)
    wx = rng.standard_normal((B, 4 * D)).astype(np.float32)
    (tr, jr), (tw, jw) = _pair(r, dtype), _pair(wx, dtype)
    state = _slstm_state(B, D, 3)
    got = tx._slstm_cell({"r": tr}, tw, tx.SLSTMState(*map(torch.from_numpy, state)), tcfg)
    want = jx._slstm_cell({"r": jr}, jw, jx.SLSTMState(*map(jnp.asarray, state)), jcfg)
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype] / 10, rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block_matches_jax(with_state):
    tcfg, jcfg = _cfgs()
    tp, jp = _params(jx.slstm_block_spec, 4)
    B, T, D = 2, 13, tcfg.d_model
    x = np.random.default_rng(5).standard_normal((B, T, D)).astype(np.float32)
    state = _slstm_state(B, D, 6) if with_state else None
    out, new = tx.slstm_block(tp, torch.from_numpy(x), tcfg,
                              state and tx.SLSTMState(*map(torch.from_numpy, state)))
    jout, jnew = jx.slstm_block(jp, jnp.asarray(x), jcfg,
                                state and jx.SLSTMState(*map(jnp.asarray, state)))
    _close(out, jout, 1e-5, rtol=1e-4)
    for g, w in zip(new, jnew):
        _close(g, w, 1e-5, rtol=1e-4)
    if not with_state:
        assert float(new.m.min()) > -1e29  # every step left the initial -1e30 behind


def test_slstm_decode_matches_jax():
    tcfg, jcfg = _cfgs()
    tp, jp = _params(jx.slstm_block_spec, 7)
    B, D = 2, tcfg.d_model
    x = np.random.default_rng(8).standard_normal((B, 1, D)).astype(np.float32)
    state = _slstm_state(B, D, 9)
    out, new = tx.slstm_decode(tp, torch.from_numpy(x), tcfg,
                               tx.SLSTMState(*map(torch.from_numpy, state)))
    jout, jnew = jx.slstm_decode(jp, jnp.asarray(x), jcfg, jx.SLSTMState(*map(jnp.asarray, state)))
    _close(out, jout, 1e-5, rtol=1e-4)
    for g, w in zip(new, jnew):
        _close(g, w, 1e-5, rtol=1e-4)


def _mlstm_state(tcfg, B, seed):
    """A carried mLSTM state at the smoke config's widths."""
    H = tcfg.num_heads
    dh = int(tcfg.xlstm.proj_factor_m * tcfg.d_model) // H
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.standard_normal((B, H, dh // 2, dh))).astype(np.float32),
            (0.5 * rng.standard_normal((B, H, dh // 2))).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


@pytest.mark.parametrize("T", [16, 13])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_block_matches_jax(T, with_state):
    tcfg, jcfg = _cfgs()
    tp, jp = _params(jx.mlstm_block_spec, 10)
    B = 2
    x = np.random.default_rng(11).standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    state = _mlstm_state(tcfg, B, 12) if with_state else None
    out, new = tx.mlstm_block(tp, torch.from_numpy(x), tcfg,
                              state and tx.MLSTMState(*map(torch.from_numpy, state)))
    jout, jnew = jx.mlstm_block(jp, jnp.asarray(x), jcfg,
                                state and jx.MLSTMState(*map(jnp.asarray, state)))
    _close(out, jout, 1e-5, rtol=1e-4)
    for g, w in zip(new, jnew):
        _close(g, w, 1e-5, rtol=1e-4)


def test_mlstm_decode_matches_jax():
    tcfg, jcfg = _cfgs()
    tp, jp = _params(jx.mlstm_block_spec, 13)
    B = 2
    x = np.random.default_rng(14).standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    state = _mlstm_state(tcfg, B, 15)
    out, new = tx.mlstm_decode(tp, torch.from_numpy(x), tcfg,
                               tx.MLSTMState(*map(torch.from_numpy, state)))
    jout, jnew = jx.mlstm_decode(jp, jnp.asarray(x), jcfg, jx.MLSTMState(*map(jnp.asarray, state)))
    _close(out, jout, 1e-5, rtol=1e-4)
    for g, w in zip(new, jnew):
        _close(g, w, 1e-5, rtol=1e-4)


@pytest.mark.parametrize("T", [24, 21, 5])
def test_port_chunkwise_matches_its_sequential_reference(T):
    """The chunkwise block against the port's own step-by-step oracle, and
    both against JAX's oracle: chunks of 8 over 24 and 21 steps, and one
    chunk shorter than the configured size."""
    tcfg, jcfg = _cfgs()
    tp, jp = _params(jx.mlstm_block_spec, 16)
    x = np.random.default_rng(17).standard_normal((2, T, tcfg.d_model)).astype(np.float32)
    chunked, _ = tx.mlstm_block(tp, torch.from_numpy(x), tcfg)
    seq = tx.mlstm_reference(tp, torch.from_numpy(x), tcfg)
    _close(chunked, seq.numpy(), 1e-5, rtol=1e-4)
    _close(seq, jx.mlstm_reference(jp, jnp.asarray(x), jcfg), 1e-5, rtol=1e-4)


def test_state_specs_start_fresh():
    tcfg, _ = _cfgs()
    ms = tx.mlstm_state_spec(tcfg, 3, torch.device("cpu"))
    ss = tx.slstm_state_spec(tcfg, 3, torch.device("cpu"))
    assert tuple(ms.c.shape) == (3, 4, 16, 32) and tuple(ms.m.shape) == (3, 4)
    assert all(tuple(t.shape) == (3, 64) for t in ss)
    for state in (ms, ss):
        assert all(t.dtype == torch.float32 for t in state)
        assert bool((state.m == -1e30).all())
        assert all(not t.any() for f, t in state._asdict().items() if f != "m")
