"""The port's MoE FFN against ``repro.models.moe`` on the same weights and
numpy inputs: ``moe_ffn`` with softmax and sigmoid routers, with and without
shared experts, in fp32 and bf16, with groups and with a capacity so low that
tokens drop; ``_scatter_moe`` against the port's one-hot oracle and against
JAX's; the dropped set against a loop over (token, choice) pairs; and
``_capacity`` and ``aux_load_balance_loss``.

Tolerances are ``tests/test_kernels.py``'s: atol 2e-5 in fp32 (summation
order), 2e-2 in bf16 (rounding at other places in the two frameworks)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models.specs import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(arch="deepseek-v2-236b", dtype="float32", **moe):
    """Both smoke configs with ``moe`` overrides, JAX's MoE parameters (the
    router fp32 whatever the dtype) and the port's nested copy."""
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jcfg = jcfg.with_overrides(dtype=dtype, moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = tcfg.with_overrides(dtype=dtype, moe=dataclasses.replace(tcfg.moe, **moe))
    jp = init_params(jm.moe_spec(jcfg, DTYPES[dtype][0]), jax.random.PRNGKey(5))
    assert jp["router"].dtype == jnp.float32
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    tp = {k: v if k == "router" else jax.tree.map(lambda t: t.to(DTYPES[dtype][1]), v)
          for k, v in tp.items()}
    return jcfg, tcfg, jp, tp


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, DTYPES[dtype][0]), torch.from_numpy(x).to(DTYPES[dtype][1])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


CASES = [
    # arch, dtype, MoE overrides
    ("deepseek-v2-236b", "float32", {}),                      # softmax, 2 shared
    ("deepseek-v3-671b", "float32", {}),                      # sigmoid, 1 shared
    ("deepseek-v2-236b", "float32", {"num_shared": 0}),
    ("deepseek-v3-671b", "float32", {"num_shared": 0}),
    ("deepseek-v2-236b", "float32", {"capacity_factor": 0.5}),  # tokens drop
    ("deepseek-v3-671b", "float32", {"capacity_factor": 0.5, "groups": 2}),
    ("deepseek-v2-236b", "bfloat16", {}),
    ("deepseek-v3-671b", "bfloat16", {"capacity_factor": 0.5}),
]


@pytest.mark.parametrize("arch,dtype,moe", CASES)
def test_moe_ffn_matches(arch, dtype, moe):
    jcfg, tcfg, jp, tp = _setup(arch, dtype, **moe)
    jx, tx = _x((2, 24, jcfg.d_model), dtype, seed=len(moe))
    jy, jaux = jm.moe_ffn(jp, jx, jcfg)
    ty, taux = tm.moe_ffn(tp, tx, tcfg)
    assert ty.dtype == DTYPES[dtype][1] and taux.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


def _dropped_by_loop(idx: np.ndarray, E: int, C: int) -> np.ndarray:
    """Which (token, choice) pairs of one group drop: in (token, k) order the
    first C pairs of each expert keep a slot."""
    seen = np.zeros(E, np.int64)
    dropped = np.zeros(idx.size, bool)
    for i, e in enumerate(idx.reshape(-1)):
        dropped[i] = seen[e] >= C
        seen[e] += 1
    return dropped


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0])
def test_scatter_moe_against_oracles_and_dropped_set(arch, capacity_factor):
    """One group of 48 tokens: the scatter dispatch against the one-hot
    oracle and against JAX's scatter dispatch; the slots the port gives
    against JAX's routing replayed by a loop over (token, choice) pairs."""
    jcfg, tcfg, jp, tp = _setup(arch, capacity_factor=capacity_factor)
    m = tcfg.moe
    jx, tx = _x((1, 48, jcfg.d_model), "float32", seed=9)
    C = tm._capacity(48, m)
    ty, taux = tm._scatter_moe(tp, tx, m)
    oy, oaux = tm._onehot_moe(tp, tx, m)
    jy, jaux = jm._scatter_moe(jp, jx, jcfg.moe)
    _close(ty, oy, TOL["float32"])
    _close(ty, jy, TOL["float32"])
    assert taux.item() == pytest.approx(oaux.item(), rel=1e-6)
    assert taux.item() == pytest.approx(float(jaux), rel=1e-5)

    logits = jnp.einsum("gsd,de->gse", jx, jp["router"])
    _, jidx = jm._topk_gates(jm._router_probs(logits, jcfg.moe), jcfg.moe)
    want = _dropped_by_loop(np.asarray(jidx[0]), m.num_experts, C)
    _, slot, _ = tm._route(tp, tx, m, C)
    got = (slot[0] == m.num_experts * C).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() == (capacity_factor < 1)  # 0.5 drops, 2.0 keeps all
    kept = slot[0][~torch.from_numpy(got)]
    assert len(set(kept.tolist())) == kept.numel()  # a kept slot holds one token


@pytest.mark.parametrize("tokens,top_k,factor,experts", [
    (48, 2, 2.0, 8), (48, 2, 0.5, 8), (4, 6, 1.25, 160), (16384, 6, 1.25, 160),
    (4096, 8, 1.25, 256), (1, 1, 1.0, 1), (100, 3, 1.0, 7)])
def test_capacity_matches(tokens, top_k, factor, experts):
    jcfg, tcfg = jax_config("deepseek-v2-236b"), get_config("deepseek-v2-236b")
    over = dict(top_k=top_k, capacity_factor=factor, num_experts=experts)
    got = tm._capacity(tokens, dataclasses.replace(tcfg.moe, **over))
    assert got == jm._capacity(tokens, dataclasses.replace(jcfg.moe, **over))
    assert got % 8 == 0 and got >= 8


def test_aux_load_balance_loss_matches():
    rng = np.random.default_rng(4)
    jcfg, tcfg = jax_config("deepseek-v3-671b", smoke=True), get_config("deepseek-v3-671b",
                                                                         smoke=True)
    probs = rng.random((3, 20, 8)).astype(np.float32)
    counts = rng.integers(0, 10, (3, 8)).astype(np.int32)
    want = jm.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(counts), jcfg.moe)
    got = tm.aux_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(counts).long(),
                                   tcfg.moe)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
