"""The port's RG-LRU: the scan (plain version, CPU dispatch, Hopper kernel)
against the JAX package's Pallas kernel in interpret mode and its associative
scan, and the recurrent block and its decode step against
``repro.models.recurrent`` on the same parameters.

Inputs are drawn with numpy and handed to both frameworks.  The JAX modules
are imported inside a fixture so that the card-only test also runs where JAX
is not installed.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_fwd  # noqa: E402
from repro_torch.models import recurrent as tr  # noqa: E402

# tests/test_kernels.py's RG-LRU cases: B, T, W, t_block, w_block.
SCAN_CASES = [
    (2, 100, 48, 32, 16),
    (1, 64, 128, 64, 128),
    (3, 33, 20, 16, 8),
]
# fp32 throughout; the sequential, blocked-associative and fma orders differ
# in rounding only, and |a| < 1 damps what accumulates.
SCAN_TOL = 1e-5
# The block: fp32 matmuls, gates and scan, against JAX's own fp32 on the CPU.
BLOCK_ATOL, BLOCK_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.kernels.rglru_scan import rglru_scan_fwd as pallas_scan
    from repro.models import recurrent as jr
    from repro.models.specs import init_params

    return SimpleNamespace(jax=jax, jnp=jnp, config=jax_config, pallas_scan=pallas_scan,
                           jr=jr, init_params=init_params)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _scan_inputs(B, T, W, seed=0):
    """test_kernels.py's distribution: a in (0.3, 0.9), small b and h0."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))) * 0.6 + 0.3
    b = rng.standard_normal((B, T, W)) * 0.1
    h0 = rng.standard_normal((B, W)) * 0.1
    return tuple(x.astype(np.float32) for x in (a, b, h0))


def _close(out, expect, atol, rtol=0.0):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, np.asarray(expect), atol=atol, rtol=rtol)


# -------------------------------------------------------------------- scan --
@pytest.mark.parametrize("path", ["ref", "ops"])
@pytest.mark.parametrize("B,T,W,tb,wb", SCAN_CASES)
def test_rglru_scan_matches_pallas_interpret(jx, B, T, W, tb, wb, path):
    arrays = _scan_inputs(B, T, W)
    expect = jx.pallas_scan(*(jx.jnp.asarray(x) for x in arrays), t_block=tb,
                            w_block=wb, interpret=True)
    a, b, h0 = (torch.from_numpy(x) for x in arrays)
    out = ref.rglru_scan_ref(a, b, h0) if path == "ref" else ops.rglru_scan(a, b, h0)
    assert out.shape == (B, T, W) and out.dtype == torch.float32
    _close(out, expect, SCAN_TOL)


@pytest.mark.parametrize("B,T,W,tb,wb", SCAN_CASES)
def test_rglru_scan_matches_jax_associative_scan(jx, B, T, W, tb, wb):
    """The model's own scan (h0 folded into b[:, 0]) computes the same recurrence."""
    arrays = _scan_inputs(B, T, W, seed=1)
    expect = jx.jr.rglru_scan(*(jx.jnp.asarray(x) for x in arrays))
    _close(ops.rglru_scan(*(torch.from_numpy(x) for x in arrays)), expect, SCAN_TOL)


def _bad_scan_inputs(kind):
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 8, 16))
    if kind == "bf16":
        return (a.bfloat16(), b, h0), TypeError, "float32"
    if kind == "strided":
        return (a, b.transpose(1, 2).contiguous().transpose(1, 2), h0), ValueError, \
            "contiguous"
    if kind == "shape":
        return (a, b, h0[:, :8]), ValueError, "shape mismatch"
    return (a, b, h0), ValueError, "CUDA tensor"


@pytest.mark.parametrize("kind", ["cpu", "bf16", "strided", "shape"])
def test_rglru_wrapper_refuses_what_the_kernel_does_not_take(kind):
    """The wrapper launches on fp32, contiguous CUDA tensors of matching shapes
    or raises; it never computes anything itself."""
    args, err, match = _bad_scan_inputs(kind)
    before = rglru_scan_fwd.launches
    with pytest.raises(err, match=match):
        rglru_scan_fwd(*args)
    assert rglru_scan_fwd.launches == before


def test_ops_rglru_refuses_unknown_device():
    a = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no rglru_scan path"):
        ops.rglru_scan(a, a, torch.empty((1, 8), device="meta"))


def test_rglru_build_raises_without_nvcc(tmp_path, monkeypatch):
    assert "rglru_scan" in build.sources()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["rglru_scan"])


@pytest.mark.cuda
def test_rglru_kernel_matches_plain_on_card(cuda):
    """Every case, plus a width that is no multiple of 32 with an odd T."""
    for B, T, W in [c[:3] for c in SCAN_CASES] + [(2, 257, 4100)]:
        a, b, h0 = (torch.from_numpy(x).to(cuda) for x in _scan_inputs(B, T, W))
        out = rglru_scan_fwd(a, b, h0)
        expect = ref.rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        _close(out.cpu(), expect.cpu(), SCAN_TOL, SCAN_TOL)


# ------------------------------------------------------------------- block --
def _block_setup(jx, seed=3):
    jcfg = jx.config("recurrentgemma-9b", smoke=True).with_overrides(dtype="float32")
    tcfg = get_config("recurrentgemma-9b", smoke=True).with_overrides(dtype="float32")
    jp = jx.init_params(jx.jr.rglru_block_spec(jcfg, jx.jnp.float32),
                        jx.jax.random.PRNGKey(seed))
    # Biases start at zero: give them values so the test sees their path.
    rng = np.random.default_rng(seed)
    jp = dict(jp, **{k: jx.jnp.asarray(rng.standard_normal(jp[k].shape).astype(np.float32))
                     for k in ("b_a", "b_i", "conv_b")})
    return jcfg, tcfg, jp, params_from_jax(jx.jax.device_get(jp))


def _state(jx, rng, B, W, cw):
    h = (rng.standard_normal((B, W)) * 0.5).astype(np.float32)
    conv = rng.standard_normal((B, cw - 1, W)).astype(np.float32)
    return (jx.jr.RGLRUState(jx.jnp.asarray(h), jx.jnp.asarray(conv)),
            tr.RGLRUState(torch.from_numpy(h), torch.from_numpy(conv)))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T", [2, 20])  # shorter and longer than the conv tail
def test_rglru_block_with_state_matches_jax(jx, T, carried):
    jcfg, tcfg, jp, tp = _block_setup(jx)
    B, D, cw = 2, jcfg.d_model, jcfg.rglru.conv_width
    rng = np.random.default_rng(T)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    js, ts = _state(jx, rng, B, D, cw) if carried else (None, None)
    jy, jst = jx.jr.rglru_block_with_state(jp, jx.jnp.asarray(x), jcfg, js)
    ty, tst = tr.rglru_block_with_state(tp, torch.from_numpy(x), tcfg, ts)
    _close(ty, jy, BLOCK_ATOL, BLOCK_RTOL)
    _close(tst.h, jst.h, BLOCK_ATOL, BLOCK_RTOL)
    _close(tst.conv, jst.conv, BLOCK_ATOL, BLOCK_RTOL)
    assert tst.h.dtype == tst.conv.dtype == torch.float32


def test_rglru_decode_matches_jax(jx):
    """Eight one-token steps from a carried state, each fed back."""
    jcfg, tcfg, jp, tp = _block_setup(jx, seed=4)
    B, D = 3, jcfg.d_model
    rng = np.random.default_rng(9)
    js, ts = _state(jx, rng, B, D, jcfg.rglru.conv_width)
    for _ in range(8):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        jy, js = jx.jr.rglru_decode(jp, jx.jnp.asarray(x), jcfg, js)
        ty, ts = tr.rglru_decode(tp, torch.from_numpy(x), tcfg, ts)
        _close(ty, jy, BLOCK_ATOL, BLOCK_RTOL)
        _close(ts.h, js.h, BLOCK_ATOL, BLOCK_RTOL)
        _close(ts.conv, js.conv, BLOCK_ATOL, BLOCK_RTOL)


def test_rglru_state_spec_matches_jax(jx):
    jcfg = jx.config("recurrentgemma-9b", smoke=True)
    spec = jx.jr.rglru_state_spec(jcfg, 3)
    st = tr.rglru_state_spec(get_config("recurrentgemma-9b", smoke=True), 3,
                             torch.device("cpu"))
    for got, want in zip(st, spec):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert str(want.dtype) == "float32" and not got.any()


# ------------------------------------------------------------ autograd --
@pytest.mark.parametrize("B,T,W,tb,wb", SCAN_CASES)
def test_rglru_scan_grads_match_jax_custom_vjp(jx, B, T, W, tb, wb):
    """ops.rglru_scan under autograd (saving a, b, h0 and recomputing the
    sequential scan's autograd) against the reference's ``jax.custom_vjp``."""
    from repro.kernels import ops as jops

    arrays = _scan_inputs(B, T, W, seed=2)
    g = np.random.default_rng(3).standard_normal((B, T, W)).astype(np.float32)
    jg = jx.jnp.asarray(g)
    want = jx.jax.grad(lambda a, b, h0: jx.jnp.sum(jops.rglru_scan(a, b, h0) * jg),
                       argnums=(0, 1, 2))(*(jx.jnp.asarray(x) for x in arrays))
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out = ops.rglru_scan(*leaves)
    assert out.grad_fn is not None
    for got, exp in zip(torch.autograd.grad(out, leaves, torch.from_numpy(g)), want):
        _close(got, exp, SCAN_TOL, 1e-5)


def test_rglru_block_train_grads_match_jax(jx):
    """The train forward (``rglru_block``) and the grads of every block
    parameter and of x, against the JAX block's (its associative scan)."""
    jcfg, tcfg, jp, tp = _block_setup(jx, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)

    def fwd_bwd(p, x_):
        y, vjp = jx.jax.vjp(lambda p_, xx: jx.jr.rglru_block(p_, xx, jcfg), p, x_)
        return y, vjp(jx.jnp.asarray(w))

    jy, (jgp, jgx) = jx.jax.jit(fwd_bwd)(jp, jx.jnp.asarray(x))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = tr.rglru_block(params, tx, tcfg)
    _close(y.detach(), jy, BLOCK_ATOL, BLOCK_RTOL)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), [tx, *params.values()])
    _close(grads[0], jgx, BLOCK_ATOL, BLOCK_RTOL)
    want = params_from_jax(jx.jax.device_get(jgp))
    for key, g in zip(params, grads[1:]):
        _close(g, want[key].numpy(), BLOCK_ATOL, BLOCK_RTOL)
