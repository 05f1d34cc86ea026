"""The port's RG-LRU: the scan (plain version, CPU dispatch, Hopper kernel)
against the JAX package's Pallas kernel in interpret mode and its associative
scan, the scan's backward (plain version, autograd dispatch, Hopper kernel)
against the cotangents of the JAX package's ``custom_vjp``, and the
recurrent block and its decode step against ``repro.models.recurrent`` on
the same parameters.

Inputs are drawn with numpy and handed to both frameworks.  The JAX modules
are imported inside a fixture so that the card-only test also runs where JAX
is not installed.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as scan_mod  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd  # noqa: E402
from repro_torch.models import recurrent as tr  # noqa: E402

# tests/test_kernels.py's RG-LRU cases: B, T, W, t_block, w_block.
SCAN_CASES = [
    (2, 100, 48, 32, 16),
    (1, 64, 128, 64, 128),
    (3, 33, 20, 16, 8),
]
# The backward's cases: SCAN_CASES, then T 1 (no step before or after the
# only one) and an h0 ten times larger than the rest (da_0 and dh0 read it).
# B, T, W, t_block, w_block, h0 scale.
BWD_CASES = [(*c, 1.0) for c in SCAN_CASES] + [(2, 1, 48, 8, 16, 1.0), (2, 37, 24, 16, 8, 10.0)]
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


# Each wrapper and the number of tensors it takes: (a, b, h0) and (a, h, h0, g).
WRAPPERS = {"fwd": (rglru_scan_fwd, 3), "bwd": (rglru_scan_bwd, 4)}


def _bad_scan_inputs(kind, n):
    """``n`` CPU tensors in a wrapper's order, one of them broken as ``kind``
    says (the forward's a or the backward's g in bf16, the second tensor or g
    strided, h0 too narrow), the error it must raise and its message."""
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 8, 16))
    args = [a, b, h0, b * 0.5][:n]
    if kind == "bf16":
        i = 3 if n == 4 else 0
        args[i] = args[i].bfloat16()
        return args, TypeError, "float32"
    if kind == "strided":
        i = 3 if n == 4 else 1
        args[i] = args[i].transpose(1, 2).contiguous().transpose(1, 2)
        return args, ValueError, "contiguous"
    if kind == "shape":
        args[2] = h0[:, :8]
        return args, ValueError, "shape mismatch"
    return args, ValueError, "CUDA tensor"


@pytest.mark.parametrize("kind,direction", [
    pytest.param(kind, direction, id=kind if direction == "fwd" else f"{kind}-{direction}")
    for direction in WRAPPERS for kind in ("cpu", "bf16", "strided", "shape")])
def test_rglru_wrapper_refuses_what_the_kernel_does_not_take(kind, direction):
    """Each wrapper launches on fp32, contiguous CUDA tensors of matching
    shapes or raises; it never computes anything itself."""
    fn, n = WRAPPERS[direction]
    args, err, match = _bad_scan_inputs(kind, n)
    before = fn.launches
    with pytest.raises(err, match=match):
        fn(*args)
    assert fn.launches == before


def test_ops_rglru_refuses_unknown_device():
    a = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no rglru_scan path"):
        ops.rglru_scan(a, a, torch.empty((1, 8), device="meta"))
    with pytest.raises(ValueError, match="no rglru_scan backward"):
        ops._scan_bwd(a, a, torch.empty((1, 8), device="meta"), a)


def test_rglru_build_raises_without_nvcc(tmp_path, monkeypatch):
    assert "rglru_scan" in build.sources()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["rglru_scan"])


# The card cases of both directions: B, T, W and the offset in elements of
# every input from its storage.  SCAN_CASES (T 64: one whole stage of the
# tma ring), then T no multiple of its 64-step stages (257, 4097) and
# shorter than one (7, 1), W a multiple of 4 but not of the 32-lane column
# (20, 36, 4100), and the shapes the tma variant cannot address, which take
# "lane": W % 4 != 0, and a view one element off aligned storage.
CARD_CASES = [(*c[:3], 0) for c in SCAN_CASES] + [
    (2, 257, 4100, 0), (1, 4097, 256, 0), (2, 7, 36, 0), (2, 1, 64, 0),
    (2, 50, 30, 0), (2, 100, 48, 1)]
# recurrentgemma-9b's training scan, where "tma" and "lane" must agree bit for bit.
TRAIN_SHAPE = (1, 4096, 4096)


def _on_card(x, device, offset=0):
    """x on the card, ``offset`` elements past the start of its storage."""
    if not offset:
        return x.to(device)
    out = torch.empty(x.numel() + offset, device=device)[offset:].view(x.shape)
    return out.copy_(x)


def _card_inputs(B, T, W, device, offset=0, scale=1.0):
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(B, T, W))
    g = torch.from_numpy(_scan_inputs(B, T, W, seed=3)[1])
    return (_on_card(a, device, offset), _on_card(b, device, offset), (h0 * scale).to(device),
            _on_card(g, device, offset))


def _launched(fn, kind, call):
    """call() once; it must launch ``fn``'s kernel once, on variant ``kind``."""
    before = dict(fn.launches_by_variant)
    out = call()
    after = dict(fn.launches_by_variant)
    assert after == {**before, kind: before[kind] + 1}, (kind, before, after)
    return out


@pytest.mark.cuda
def test_rglru_bwd_kernel_matches_plain_on_card(cuda, monkeypatch):
    """The backward kernel against its plain version on the forward's h in
    every card case, on the variant the rule names (every backward case too:
    T 1 and a large h0), and T 0 (zeros, no launch); at the training shape
    the tma variant against the lane one (the same arithmetic in the same
    order), and a second call that repeats the first bit for bit."""
    cases = [(*c[:3], 0, c[5]) for c in BWD_CASES] + [(*c, 1.0) for c in CARD_CASES]
    for B, T, W, offset, scale in cases:
        a, b, h0, g = _card_inputs(B, T, W, cuda, offset, scale)
        h = _on_card(rglru_scan_fwd(a, b, h0), cuda, offset)
        kind = "tma" if W % 4 == 0 and not offset else "lane"
        assert scan_mod.variant(a, h, g) == kind
        got = _launched(rglru_scan_bwd, kind, lambda: rglru_scan_bwd(a, h, h0, g))
        want = ref.rglru_scan_bwd_ref(a, h, h0, g)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            _close(x.cpu(), y.cpu(), SCAN_TOL, SCAN_TOL)
    a, b, h0, g = _card_inputs(*TRAIN_SHAPE, cuda)
    h = rglru_scan_fwd(a, b, h0)
    tma = _launched(rglru_scan_bwd, "tma", lambda: rglru_scan_bwd(a, h, h0, g))
    again = rglru_scan_bwd(a, h, h0, g)
    monkeypatch.setattr(scan_mod, "variant", lambda *_: "lane")
    lane = _launched(rglru_scan_bwd, "lane", lambda: rglru_scan_bwd(a, h, h0, g))
    for x, y, z in zip(tma, again, lane):
        assert torch.equal(x, y) and torch.equal(x, z)
    empty = torch.zeros((1, 0, 8), device=cuda)
    before = rglru_scan_bwd.launches
    da, db, dh0 = rglru_scan_bwd(empty, empty, torch.ones((1, 8), device=cuda), empty)
    assert rglru_scan_bwd.launches == before and da.shape == db.shape == (1, 0, 8)
    assert not dh0.cpu().any()


@pytest.mark.cuda
def test_rglru_kernel_matches_plain_on_card(cuda, monkeypatch):
    """Every card case on the variant the rule names; at the training shape
    the tma variant's h equal to the lane one's and a second call's."""
    for B, T, W, offset in CARD_CASES:
        a, b, h0, _ = _card_inputs(B, T, W, cuda, offset)
        kind = "tma" if W % 4 == 0 and not offset else "lane"
        out = _launched(rglru_scan_fwd, kind, lambda: rglru_scan_fwd(a, b, h0))
        expect = ref.rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        _close(out.cpu(), expect.cpu(), SCAN_TOL, SCAN_TOL)
    a, b, h0, _ = _card_inputs(*TRAIN_SHAPE, cuda)
    tma = _launched(rglru_scan_fwd, "tma", lambda: rglru_scan_fwd(a, b, h0))
    again = rglru_scan_fwd(a, b, h0)
    monkeypatch.setattr(scan_mod, "variant", lambda *_: "lane")
    lane = _launched(rglru_scan_fwd, "lane", lambda: rglru_scan_fwd(a, b, h0))
    assert torch.equal(tma, again) and torch.equal(tma, lane)


# ---------------------------------------------------------------- variant --
def _described(B, T, W, offset=0, device="cpu"):
    """A [B,T,W] fp32 tensor ``offset`` elements past its storage's start
    (CPU storage is 64-byte aligned); on ``meta`` its data_ptr is 0."""
    return torch.empty(B * T * W + offset, device=device)[offset:].view(B, T, W)


@pytest.mark.parametrize("shapes,want", [
    pytest.param([(2, 9, 16, 0)] * 2, "tma", id="aligned"),
    pytest.param([(1, 4096, 4096, 0)] * 3, "tma", id="training-shape"),
    pytest.param([(2, 9, 16, 1)] * 2, "lane", id="misaligned"),
    pytest.param([(2, 9, 16, 0), (2, 9, 16, 2)], "lane", id="second-input-misaligned"),
    pytest.param([(2, 9, 16, 0)] * 2 + [(2, 9, 16, 4)], "tma", id="offset-by-16-bytes"),
    pytest.param([(2, 9, 30, 0)] * 2, "lane", id="w-not-multiple-of-4"),
    pytest.param([(2, 9, 20, 0)] * 2, "tma", id="w-multiple-of-4-not-of-the-column"),
    pytest.param([(2, 0, 16, 0)] * 2, "lane", id="empty-t"),
    pytest.param([(0, 9, 16, 0)] * 2, "lane", id="empty-b"),
])
def test_rglru_variant_rule(shapes, want):
    assert scan_mod.variant(*(_described(*s) for s in shapes)) == want


@pytest.mark.parametrize("shape,want", [
    ((1, 2 ** 31 - 1 - 2 * scan_mod.ROWS, 4), "tma"),
    ((1, 2 ** 31 - 2 * scan_mod.ROWS, 4), "lane"),  # no room for a stage past T
    ((2, 2 ** 19, 2 ** 19 - 4), "tma"),
    ((2, 2 ** 19, 2 ** 19), "lane"),         # a batch stride of 2^40 bytes
])
def test_rglru_variant_rule_at_the_tensor_map_limits(shape, want):
    assert scan_mod.variant(_described(*shape, device="meta")) == want


@pytest.mark.parametrize("err,match", [(-2, "CUresult 2"), (715, "cudaError 715")])
def test_launch_errors_raise(err, match):
    """A C entry's error code (a cudaError_t, or minus a CUresult of a tensor
    map that could not be encoded) always raises, naming the call."""
    with pytest.raises(RuntimeError, match=f"rglru_scan.*{match}"):
        build.raise_on(err, "rglru_scan")
    build.raise_on(0, "rglru_scan")


def test_rglru_ring_constants_match_the_kernel_source():
    """The variant rule's T limit counts the kernel's stage rows."""
    src = (build.CSRC / "rglru_scan.cu").read_text()
    assert re.search(r"constexpr int ROWS = (\d+);", src)[1] == str(scan_mod.ROWS)


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
def _jax_scan_grads(jx, arrays, g):
    """(da, db, dh0) of the JAX package's ``rglru_scan`` (its Pallas forward
    in interpret mode under its ``custom_vjp``) for the cotangent g."""
    from repro.kernels import ops as jops

    jg = jx.jnp.asarray(g)
    return jx.jax.grad(lambda a, b, h0: jx.jnp.sum(jops.rglru_scan(a, b, h0) * jg),
                       argnums=(0, 1, 2))(*(jx.jnp.asarray(x) for x in arrays))


@pytest.mark.parametrize("B,T,W,tb,wb,scale", BWD_CASES)
def test_rglru_scan_bwd_ref_matches_jax_custom_vjp(jx, B, T, W, tb, wb, scale):
    """The plain backward, on the plain forward's h, against the reference's
    cotangents."""
    a, b, h0 = _scan_inputs(B, T, W, seed=4)
    arrays = (a, b, h0 * np.float32(scale))
    g = np.random.default_rng(5).standard_normal((B, T, W)).astype(np.float32)
    want = _jax_scan_grads(jx, arrays, g)
    a, b, h0 = (torch.from_numpy(x) for x in arrays)
    got = ref.rglru_scan_bwd_ref(a, ref.rglru_scan_ref(a, b, h0), h0, torch.from_numpy(g))
    assert [tuple(x.shape) for x in got] == [(B, T, W), (B, T, W), (B, W)]
    for x, exp in zip(got, want):
        _close(x, exp, SCAN_TOL, SCAN_TOL)


def test_rglru_scan_backward_on_cpu_takes_the_plain_backward(monkeypatch):
    """``_RGLRUScan.backward`` on CPU tensors calls ``ref.rglru_scan_bwd_ref``
    once, on the saved h, and never the forward's plain version."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in _scan_inputs(2, 9, 16)]
    out = ops.rglru_scan(*leaves)

    def refuse(*args):
        raise AssertionError("the backward recomputed the forward")

    calls, real = [], ref.rglru_scan_bwd_ref
    monkeypatch.setattr(ref, "rglru_scan_ref", refuse)
    monkeypatch.setattr(ref, "rglru_scan_bwd_ref",
                        lambda *args: calls.append(args) or real(*args))
    grads = torch.autograd.grad(out, leaves, torch.ones_like(out))
    assert len(calls) == 1 and calls[0][1] is not None
    torch.testing.assert_close(calls[0][1], out.detach(), rtol=0, atol=0)
    assert [g.shape for g in grads] == [x.shape for x in leaves]


@pytest.mark.parametrize("B,T,W,tb,wb", SCAN_CASES)
def test_rglru_scan_grads_match_jax_custom_vjp(jx, B, T, W, tb, wb):
    """ops.rglru_scan under autograd (saving a, its output h and h0; the
    backward runs the plain reverse scan on the CPU) against the reference's
    ``jax.custom_vjp``."""
    arrays = _scan_inputs(B, T, W, seed=2)
    g = np.random.default_rng(3).standard_normal((B, T, W)).astype(np.float32)
    want = _jax_scan_grads(jx, arrays, g)
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out = ops.rglru_scan(*leaves)
    assert out.grad_fn is not None
    for got, exp in zip(torch.autograd.grad(out, leaves, torch.from_numpy(g)), want):
        _close(got, exp, SCAN_TOL, 1e-5)


def test_rglru_block_train_grads_match_jax(jx):
    """The train forward (``rglru_block``) and the grads of every block
    parameter and of x (the scan's through the plain reverse scan on the
    CPU), against the JAX block's (its associative scan)."""
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
