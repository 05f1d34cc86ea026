"""The port's MLA (multi-head latent attention) against
``repro.models.attention`` on the same weights and numpy inputs: training
attention in fp32 and bf16, prefill against the reference's
``online_attention`` route with its cache, absorbed-weight decode steps, and
the cache's shapes.

Tolerances are ``tests/test_kernels.py``'s: atol 2e-5 in fp32 (summation
order), 2e-2 in bf16 (rounding at other places in the two frameworks: the
reference rounds the scaled queries and P to bf16, the port's plain version
does not).  That test's outputs are of unit scale; a block's outputs reach
5-8, where one bf16 ulp is 3.1e-2, so in bf16 the bound is 2e-2 of the
largest |value| (and never under 2e-2)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import MLAConfig  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models.specs import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MLAConfig as TorchMLAConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(dtype="float32", q_lora=True, arch="deepseek-v2-236b"):
    """Both configs at smoke width, JAX's MLA parameters and the port's copy.
    ``q_lora=False`` takes the uncompressed query (``wq``)."""
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    if not q_lora:
        jcfg = jcfg.with_overrides(mla=MLAConfig(**{**vars(jcfg.mla), "q_lora_rank": 0}))
        tcfg = tcfg.with_overrides(mla=TorchMLAConfig(**{**vars(tcfg.mla), "q_lora_rank": 0}))
    jcfg, tcfg = jcfg.with_overrides(dtype=dtype), tcfg.with_overrides(dtype=dtype)
    jp = init_params(ja.mla_spec(jcfg, DTYPES[dtype][0]), jax.random.PRNGKey(11))
    # The same nested tree in torch (bf16 through fp32 is exact).
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        DTYPES[dtype][1]), jp)
    return jcfg, tcfg, jp, tp


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype] * scale, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_attention_matches(dtype, q_lora):
    jcfg, tcfg, jp, tp = _setup(dtype, q_lora)
    jx, tx = _x((2, 20, jcfg.d_model), dtype, seed=1)
    _close(ta.mla_attention(tp, tx, tcfg), ja.mla_attention(jp, jx, jcfg), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_then_decode_matches(dtype):
    """Prefill (the reference runs ``online_attention`` there) fills the
    cache in place; five absorbed-weight decode steps each write one slot."""
    jcfg, tcfg, jp, tp = _setup(dtype)
    B, T, max_len, steps = 2, 11, 16, 5
    jx, tx = _x((B, T, jcfg.d_model), dtype, seed=2)
    jy, jc = ja.mla_prefill(jp, jx, jcfg, max_len)
    cache = ta.mla_cache_spec(tcfg, B, max_len, DTYPES[dtype][1], torch.device("cpu"))
    ty, tc = ta.mla_prefill(tp, tx, tcfg, cache)
    _close(ty, jy, dtype)
    _close(tc.c_kv, jc.c_kv, dtype)
    _close(tc.k_rope, jc.k_rope, dtype)
    assert tc.length == int(jc.length) == T
    assert tc.c_kv.data_ptr() == cache.c_kv.data_ptr()  # filled in place

    for step in range(steps):
        jx, tx = _x((B, 1, jcfg.d_model), dtype, seed=10 + step)
        jy, jc = ja.mla_decode(jp, jx, jcfg, jc)
        ty, tc = ta.mla_decode(tp, tx, tcfg, tc)
        _close(ty, jy, dtype)
        _close(tc.c_kv, jc.c_kv, dtype)
        _close(tc.k_rope, jc.k_rope, dtype)
        assert tc.length == int(jc.length) == T + step + 1


def test_mla_decode_without_query_compression():
    jcfg, tcfg, jp, tp = _setup(q_lora=False)
    B, T, max_len = 2, 6, 9
    jx, tx = _x((B, T, jcfg.d_model), "float32", seed=3)
    _, jc = ja.mla_prefill(jp, jx, jcfg, max_len)
    _, tc = ta.mla_prefill(tp, tx, tcfg,
                           ta.mla_cache_spec(tcfg, B, max_len, torch.float32,
                                             torch.device("cpu")))
    for step in range(3):
        jx, tx = _x((B, 1, jcfg.d_model), "float32", seed=20 + step)
        jy, jc = ja.mla_decode(jp, jx, jcfg, jc)
        ty, tc = ta.mla_decode(tp, tx, tcfg, tc)
        _close(ty, jy, "float32")


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_mla_cache_shapes_match_spec(arch):
    """One layer's cache against ``mla_cache_spec``, and the model's whole
    cache tree (``lead`` per layer, ``blocks`` stacked) against JAX's."""
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    spec = ja.mla_cache_spec(jcfg, 3, 40, jnp.bfloat16)
    got = ta.mla_cache_spec(tcfg, 3, 40, torch.bfloat16, torch.device("cpu"))
    assert tuple(got.c_kv.shape) == spec.c_kv.shape == (3, 40, 32)
    assert tuple(got.k_rope.shape) == spec.k_rope.shape == (3, 40, 8)
    assert got.c_kv.dtype == got.k_rope.dtype == torch.bfloat16
    assert got.length == 0 and not got.c_kv.any()

    want = JaxModel(jcfg).cache(3, 40, as_spec=True)
    have = Model(tcfg, device="cpu").cache(3, 40)
    assert len(have["lead"]) == len(want["lead"]) == 1 and have["tail"] == want["tail"] == []
    pairs = [(have["lead"][0], want["lead"][0]), (have["blocks"]["b0"], want["blocks"]["b0"])]
    for h, w in pairs:
        assert tuple(h.c_kv.shape) == w.c_kv.shape
        assert tuple(h.k_rope.shape) == w.k_rope.shape
