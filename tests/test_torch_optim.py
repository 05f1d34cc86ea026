"""The port's AdamW and schedule: the reference's own cases
(``tests/test_optim.py``) against the port, then parity with the JAX
package on identical gradients, including the decay of the stacked
``[n_scan, D]`` norm scales and the lr-0 first step of a warmup."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.steps import _adamw_piece  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine_schedule  # noqa: E402
from repro_torch.configs import RunConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, global_norm  # noqa: E402


def _t(x):
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in x.items()}


# ----------------------------------------------- the reference's own cases --
def test_adamw_matches_hand_math():
    p = _t({"w": [1.0, -2.0]})
    g = _t({"w": [0.5, 0.5]})
    st = adamw_init(p)
    lr, b1, b2, eps = 0.1, 0.9, 0.95, 1e-8
    newst, _ = adamw_update(p, g, st, lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0,
                            grad_clip=0.0)
    m = (1 - b1) * np.array([0.5, 0.5])
    v = (1 - b2) * np.array([0.25, 0.25])
    expect = np.array([1.0, -2.0]) - lr * (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)
    np.testing.assert_allclose(p["w"].numpy(), expect, rtol=1e-6)
    assert int(newst.step) == 1 and newst.step.dtype == torch.int32


def test_weight_decay_decoupled_and_matrix_only():
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    adamw_update(p, g, adamw_init(p), lr=0.5, weight_decay=0.1, grad_clip=0.0)
    np.testing.assert_allclose(p["w"].numpy(), 0.95 * np.ones((2, 2)), rtol=1e-6)
    np.testing.assert_allclose(p["b"].numpy(), np.ones((2,)), rtol=1e-6)


def test_grad_clipping_scales_update():
    p = {"w": torch.zeros((3,))}
    g = _t({"w": [30.0, 40.0, 0.0]})  # norm 50
    _, m = adamw_update(p, g, adamw_init(p), lr=0.1, grad_clip=1.0)
    np.testing.assert_allclose(float(m["grad_norm"]), 50.0, rtol=1e-6)


def test_global_norm():
    assert float(global_norm(_t({"a": [3.0], "b": [4.0]}))) == 5.0


def test_bf16_moments_are_stored_in_bf16_and_computed_in_fp32():
    p = {"w": torch.ones((2, 3), dtype=torch.bfloat16)}
    g = {"w": torch.full((2, 3), 0.3, dtype=torch.bfloat16)}
    st = adamw_init(p, torch.bfloat16)
    st, _ = adamw_update(p, g, st, lr=0.0, grad_clip=0.0)
    g32 = g["w"].float()
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.bfloat16
    assert torch.equal(st.mu["w"], (0.1 * g32).to(torch.bfloat16))
    assert torch.equal(st.nu["w"], (0.05 * g32 * g32).to(torch.bfloat16))
    assert torch.equal(p["w"], torch.ones((2, 3), dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype,state_dtype", [(torch.float32, torch.float32),
                                               (torch.bfloat16, torch.float32),
                                               (torch.bfloat16, torch.bfloat16)])
def test_chunked_update_gives_the_whole_tensors_bits(monkeypatch, dtype, state_dtype):
    """A chunk of 7 elements walks a 5 x 9 tensor in 6 full chunks and a
    tail of 3 (and a 1-D tensor, a 0-d one and one under a chunk): three
    steps give parameters, mu and nu bit for bit as one chunk does; the
    global norm moves only in its summation order.  The gradients' norm
    stays under the clip, so the clip factor is exactly 1 both ways."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 9), "b": (11,), "s": (), "t": (2, 3)}
    init = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for k, s in shapes.items()}
    grads = [{k: torch.as_tensor(0.05 * rng.standard_normal(s).astype(np.float32)).to(dtype)
              for k, s in shapes.items()} for _ in range(3)]
    assert adamw.CHUNK_ELEMENTS == 2 ** 26
    runs = {}
    for chunk in (2 ** 26, 7):
        monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", chunk)
        p = {k: v.clone() for k, v in init.items()}
        st = adamw_init(p, state_dtype)
        norms = []
        for i, g in enumerate(grads):
            st, m = adamw_update(p, g, st, lr=torch.tensor(0.05 * (i + 1)), grad_clip=1.0)
            assert float(m["grad_norm"]) < 1.0
            norms.append(m["grad_norm"])
        runs[chunk] = (p, st, norms)
    (p1, st1, n1), (p7, st7, n7) = runs[2 ** 26], runs[7]
    assert len(adamw._chunks(init["w"])) == 7 and adamw._chunks(init["w"])[-1].numel() == 3
    for group, a, b in (("params", p1, p7), ("mu", st1.mu, st7.mu), ("nu", st1.nu, st7.nu)):
        for k in shapes:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (group, k)
            assert a[k].shape == shapes[k]
    for x, y in zip(n1, n7):
        torch.testing.assert_close(x, y, atol=0, rtol=1e-6)


def test_chunked_global_norm_reads_every_chunk(monkeypatch):
    monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", 4)
    t = {"a": torch.arange(10, dtype=torch.bfloat16).reshape(2, 5), "b": torch.ones(3)}
    want = np.sqrt(sum(i * i for i in range(10)) + 3)
    np.testing.assert_allclose(float(global_norm(t)), want, rtol=1e-7)


def test_cosine_schedule_shape():
    lrs = [float(cosine_schedule(s, peak_lr=1.0, warmup=10, total=100)) for s in range(100)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 0.06          # warmup peak
    assert lrs[99] < 0.2                       # decayed
    assert min(lrs[10:]) >= 0.1 - 1e-6         # floor


# ---------------------------------------------------- parity with the JAX --
@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 1), (5, 40), (10, 100), (100, 1000)])
def test_cosine_schedule_matches_jax(warmup, total):
    steps = np.arange(total + 5)
    got = cosine_schedule(torch.as_tensor(steps, dtype=torch.int32), peak_lr=3e-4,
                          warmup=warmup, total=total)
    want = jax_cosine_schedule(jnp.asarray(steps), peak_lr=3e-4, warmup=warmup, total=total)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)


# The clip factor differs in its last bit between the frameworks (the global
# norm sums squares in another order), which moves fp32 moments by ~1e-9 and
# a bf16 value by at most one ulp (2^-7 of it).
TOL = {torch.float32: dict(atol=1e-7, rtol=1e-5), torch.bfloat16: dict(atol=1e-7, rtol=2 ** -7)}


def _model_tree(dtype):
    params = JaxModel(jax_config("recurrentgemma-9b", smoke=True).with_overrides(
        dtype=dtype)).init(jax.random.PRNGKey(0))
    return jax.device_get(params)


@pytest.mark.parametrize("dtype,state_dtype", [("float32", "float32"), ("bfloat16", "float32")])
def test_adamw_five_steps_on_identical_grads_match_jax(dtype, state_dtype):
    """recurrentgemma's smoke tree (stacked ``[n_scan, D]`` norm scales, 1-D
    tail scales and biases, fp32 ``lam``), five steps through the
    reference's ``_adamw_piece`` (the schedule read at the step before the
    increment: lr 0 first) and the port's schedule + update."""
    run = RunConfig(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                    weight_decay=0.1, grad_clip=1.0, optimizer_state_dtype=state_dtype)
    jp = _model_tree(dtype)
    sdt = jnp.float32 if state_dtype == "float32" else jnp.bfloat16
    jopt = jax_adamw_init(jp, sdt)
    jopt = {"step": jopt.step, "mu": jopt.mu, "nu": jopt.nu}
    params = params_from_jax(jp)
    st = adamw_init(params, getattr(torch, state_dtype))
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    piece = jax.jit(lambda p, g, o: _adamw_piece(run, p, g, o))
    first = {k: v.clone() for k, v in params.items()}
    for i in range(5):
        grads = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(rng.standard_normal(x.shape) * 0.3, x.dtype) for x in leaves])
        jp, jopt, jm = piece(jp, grads, jopt)
        lr = cosine_schedule(st.step, peak_lr=run.learning_rate, warmup=run.warmup_steps,
                             total=run.total_steps)
        st, m = adamw_update(params, params_from_jax(jax.device_get(grads)), st, lr,
                             weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        if i == 0:  # lr 0: only the moments moved
            for k, p in params.items():
                assert torch.equal(p, first[k]), k
    for group, got in (("params", params), ("mu", st.mu), ("nu", st.nu)):
        want = params_from_jax(jax.device_get(jp if group == "params" else jopt[group]))
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.dtype == want[k].dtype, (group, k)
            torch.testing.assert_close(t, want[k], msg=f"{group} {k}", **TOL[t.dtype])
    assert int(st.step) == int(jopt["step"]) == 5
    # The stacked norm scale decays, the final one does not: with a zero
    # gradient only decay moves a parameter.
    p = {"blocks.b0.ln1.scale": torch.ones((3, 4)), "final_norm.scale": torch.ones((4,))}
    adamw_update(p, {k: torch.zeros_like(v) for k, v in p.items()}, adamw_init(p),
                 lr=1.0, weight_decay=0.1, grad_clip=0.0)
    assert torch.all(p["blocks.b0.ln1.scale"] == 0.9)
    assert torch.all(p["final_norm.scale"] == 1.0)
