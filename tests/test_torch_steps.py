"""The port's train step against the JAX package's: a microbatched gradient
against ``_grad_fn`` (llama3.2-1b and the recurrentgemma-9b hybrid), and
fp32 accumulation of bf16 gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import _grad_fn as jax_grad_fn  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.steps import grad_fn  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCHS = ("llama3.2-1b", "recurrentgemma-9b")
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)  # fp32 on both sides: summation order only


def _models(arch):
    jm = JaxModel(jax_config(arch, smoke=True).with_overrides(dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch, smoke=True).with_overrides(dtype="float32"), device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jm, jp, tm


def _batch(vocab, B, T, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_grads_match_jax_grad_fn(arch):
    """Two microbatches: each one's grads cast to fp32, summed, halved."""
    jm, jp, tm = _models(arch)
    batch = _batch(jm.cfg.vocab_size, 4, 16, seed=2)
    with set_mesh(make_mesh((1, 1), ("data", "model"))):
        (jloss, jmetrics), jg = jax.jit(jax_grad_fn(jm.loss, 2))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = grad_fn(tm, 2)(_torch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD_TOL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jmetrics["ce"]), **GRAD_TOL)
    expect = params_from_jax(jax.device_get(jg))
    assert set(grads) == set(expect)
    for key, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), expect[key].numpy(), err_msg=key, **GRAD_TOL)


def test_microbatches_sum_in_fp32_not_the_parameter_dtype():
    """bf16 model: the accumulated grads are fp32 and equal the fp32 mean of
    the two halves' own grads, exactly."""
    tm = Model(get_config("llama3.2-1b", smoke=True), device="cpu")
    batch = _batch(256, 4, 8, seed=3)
    _, _, acc = grad_fn(tm, 2)(_torch(batch))
    halves = [grad_fn(tm, 1)(_torch({k: v[i:i + 2] for k, v in batch.items()}))[2]
              for i in (0, 2)]
    for key, g in acc.items():
        assert g.dtype == torch.float32 and halves[0][key].dtype == torch.bfloat16
        torch.testing.assert_close(g, (halves[0][key].float() + halves[1][key].float()) / 2,
                                   atol=0, rtol=0)
