"""The port's flash attention (plain version, CPU dispatch, Hopper kernel)
against the JAX package's oracle and its Pallas kernel in interpret mode.

Inputs are drawn once with numpy and handed to both frameworks.  The JAX
modules are imported inside a fixture so that the card-only test at the end
also runs where JAX is not installed.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402

# tests/test_kernels.py's FLASH_CASES, dtypes by name.
FLASH_CASES = [
    # B, T, H, K, dk, dv, qb, kb, causal, window, dtype
    (2, 64, 4, 2, 32, 32, 16, 32, True, 0, "float32"),
    (1, 96, 8, 8, 64, 64, 32, 32, True, 24, "float32"),
    (2, 48, 4, 1, 16, 16, 16, 16, False, 0, "float32"),
    (1, 80, 4, 2, 32, 16, 32, 16, True, 0, "bfloat16"),  # MLA-style dk!=dv
    (1, 50, 2, 2, 16, 16, 16, 16, True, 0, "float32"),   # ragged T
    (3, 32, 6, 3, 8, 8, 32, 32, True, 0, "float32"),     # single block
]
# fp32: summation order only; bf16: one rounding of the output and of P.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, seed=0):
    B, T, H, K, dk, dv = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, dk), np.float32),
            rng.standard_normal((B, T, K, dk), np.float32),
            rng.standard_normal((B, T, K, dv), np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


def _np(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("path", ["ref", "ops"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax_ref(jx, case, path):
    B, T, H, K, dk, dv, qb, kb, causal, window, dt = case
    arrays = _inputs(case)
    jq, jk, jv = (jx.jnp.asarray(a, getattr(jx.jnp, dt)) for a in arrays)
    expect = jx.ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    q, k, v = _torch(arrays, dt)
    if path == "ref":
        out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    else:
        out = ops.flash_attention(q, k, v, causal, window, qb, kb, None)
    assert out.shape == (B, T, H, dv) and out.dtype == v.dtype
    np.testing.assert_allclose(_np(out), _np(expect), atol=TOL[dt])


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[3]])
def test_flash_attention_matches_pallas_interpret(jx, case):
    """The Pallas kernel itself (interpret mode) against the port's CPU path."""
    B, T, H, K, dk, dv, qb, kb, causal, window, dt = case
    arrays = _inputs(case, seed=1)
    jq, jk, jv = (jx.jnp.asarray(a, getattr(jx.jnp, dt)) for a in arrays)
    expect = jx.ops.flash_attention(jq, jk, jv, causal, window, qb, kb, None)
    out = ops.flash_attention(*_torch(arrays, dt), causal, window, qb, kb, None)
    np.testing.assert_allclose(_np(out), _np(expect), atol=TOL[dt])


def test_flash_attention_explicit_scale(jx):
    case = FLASH_CASES[0]
    arrays = _inputs(case, seed=2)
    jq, jk, jv = (jx.jnp.asarray(a) for a in arrays)
    expect = jx.ref.flash_attention_ref(jq, jk, jv, causal=True, scale=0.3)
    out = ops.flash_attention(*_torch(arrays, "float32"), True, 0, 16, 16, 0.3)
    np.testing.assert_allclose(_np(out), _np(expect), atol=TOL["float32"])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises; it never computes on the CPU."""
    q, k, v = _torch(_inputs(FLASH_CASES[0]), "float32")
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before


def test_ops_refuses_unknown_device():
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no flash_attention path"):
        ops.flash_attention(q, q, q)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    assert "flash_attention" in build.sources()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["flash_attention"])


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card(cuda):
    """Every case, plus windowed bf16 (d 64, and recurrentgemma's MQA at d 256)
    and a d=128 bf16 case, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = FLASH_CASES + [(2, 200, 8, 2, 64, 64, 0, 0, True, 48, "bfloat16"),
                           (1, 130, 4, 2, 128, 128, 0, 0, True, 0, "bfloat16"),
                           (1, 300, 4, 1, 256, 256, 0, 0, True, 64, "bfloat16")]
    for case in cases:
        causal, window, dt = case[8:]
        q, k, v = _torch(_inputs(case), dt, cuda)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(out), _np(expect), atol=TOL[dt], err_msg=str(case))
