"""xlstm-1.3b at its published depth, 48 blocks (six super-blocks of seven
mLSTM and one sLSTM, each under remat), at smoke width: the port against
the JAX package on one set of weights and one batch, in fp32 and in bf16.

fp32 holds the loss, the logits and every gradient.  In bf16 neither
framework's result is near fp32 at this depth: the roundings of 48 blocks
carry the reference's own logits about 48 % (relative L2) and its gradient
about 145 % away from its fp32 values, so no tolerance can hold the port to
JAX's bf16 roundings one for one.  The bf16 test holds the port's bf16 as
far from fp32 as JAX's bf16 is, and the port no farther from JAX's bf16
than JAX's bf16 is from fp32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCH = "xlstm-1.3b"
DEPTH = dict(num_layers=48, block_pattern=("mlstm",) * 7 + ("slstm",))
# fp32 on both sides, summation order only, carried through 48 blocks: this
# test's run (``pytest -s`` prints the gaps) reads the loss 2.4e-7 apart
# relative, the logits 3.9e-5 and the gradient 2.0e-4 relative L2 (as a
# whole; the worst leaf 6.5e-4).  The limits sit about ten times above.  At
# 4 blocks the same comparison holds atol 1e-5 / rtol 1e-4 per element
# (tests/test_torch_train.py).
FP32_TOL = {"loss": 1e-5, "logits": 5e-4, "grad": 2e-3, "leaf": 5e-3}
# bf16: the port's distance to fp32 is JAX's within this factor either way
# (read 0.97 for the logits, 0.82 for the gradient), and its distance to
# JAX's bf16 at most this factor of JAX's own distance to fp32 (read 0.97
# and 0.84).
BF16_FACTOR = 1.5


@pytest.fixture(scope="module")
def runs():
    """Loss, logits and gradients of the JAX model and the port, each in bf16
    and in fp32, on JAX's bf16 initial weights (upcast for fp32)."""
    jcfg = jax_config(ARCH, smoke=True).with_overrides(dtype="bfloat16", **DEPTH)
    jp16 = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dtype, jp in (("bfloat16", jp16), ("float32", jp32)):
        jm = JaxModel(jax_config(ARCH, smoke=True).with_overrides(dtype=dtype, **DEPTH))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
        logits = jax.jit(lambda p, b: jm._logits(p, jm.forward(p, b)[0]))(jp, jb)
        out["jax", dtype] = (float(loss), np.asarray(logits.astype(jnp.float32)),
                             {k: v.float().numpy() for k, v in
                              params_from_jax(jax.device_get(g)).items()})
        tm = Model(get_config(ARCH, smoke=True).with_overrides(dtype=dtype, **DEPTH),
                   device="cpu")
        tm.load_state_dict(params_from_jax(jax.device_get(jp)))
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        loss, _ = tm.loss(tb)
        names = [n for n, _ in tm.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
        with torch.no_grad():
            logits = tm._logits(tm.forward(tb)[0])
        out["port", dtype] = (loss.item(), logits.float().numpy(),
                              {n: g.float().numpy() for n, g in zip(names, grads)})
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grad_rel(a, b) -> float:
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    return (num / sum(float(np.sum(b[k] ** 2)) for k in b)) ** 0.5


def test_full_depth_fp32_loss_logits_and_every_grad_match_jax(runs):
    loss, logits, grads = runs["port", "float32"]
    jloss, jlogits, jgrads = runs["jax", "float32"]
    assert set(grads) == set(jgrads) and len(grads) > 0
    gaps = {"loss": abs(loss - jloss) / abs(jloss), "logits": _rel(logits, jlogits),
            "grad": _grad_rel(grads, jgrads),
            "leaf": max(_rel(grads[k], jgrads[k]) for k in jgrads)}
    print(f"fp32 at 48 blocks: {gaps}")
    for key, tol in FP32_TOL.items():
        assert gaps[key] < tol, (key, gaps)


def test_full_depth_bf16_stays_within_the_references_own_rounding(runs):
    gaps = {}
    for part in (1, 2):
        dist = _rel if part == 1 else _grad_rel
        gaps[part] = (dist(runs["port", "bfloat16"][part], runs["port", "float32"][part]),
                      dist(runs["jax", "bfloat16"][part], runs["jax", "float32"][part]),
                      dist(runs["port", "bfloat16"][part], runs["jax", "bfloat16"][part]))
    print(f"bf16 at 48 blocks, (port to its fp32, JAX to its fp32, port to JAX), logits "
          f"{gaps[1]}, gradient {gaps[2]}")
    for part, (port, ref, between) in gaps.items():
        assert ref / BF16_FACTOR < port < ref * BF16_FACTOR, (part, gaps)
        assert between < ref * BF16_FACTOR, (part, gaps)
    loss16, loss32 = runs["port", "bfloat16"][0], runs["port", "float32"][0]
    assert np.isfinite(loss16) and abs(loss16 - loss32) / loss32 < 2e-3
