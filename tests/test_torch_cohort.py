"""The port's cohort collectives (``core/cohort.py``) and cost model
(``core/asymmetry.py``) against the JAX package's: int8 quantisation with
error feedback against JAX's on the same inputs; then, on 4 gloo ranks of a
2 pods x 2 data mesh on the CPU, the cohort and flat all-reduces against
the sum (the contract of ``tests/test_cohort_collectives.py``), the bytes
they count against ``asymmetry``'s formulas, and the error feedback's
convergence with that test's bounds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core.cohort import _ef_quantize as jax_ef_quantize  # noqa: E402
from repro_torch.core.asymmetry import (H100, all_gather_wire_bytes,  # noqa: E402
                                        allreduce_wire_bytes, cohort_vs_flat_dcn_bytes,
                                        reduce_scatter_wire_bytes)
from repro_torch.core.cohort import _ef_quantize  # noqa: E402
from repro_torch.launch.mesh import group_backend, group_spans, make_mesh, spawn_ranks  # noqa: E402

import torch_rank_fns  # noqa: E402

TREE_ELEMENTS = 27  # w [4, 6] and b [3]: no cohort of 2 divides it


@pytest.fixture(scope="module")
def ranks():
    """One run of 4 ranks (2 pods x 2 data) for the collective tests."""
    g = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    return g, spawn_ranks(torch_rank_fns.cohort_checks, 4, (g,), timeout=120)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_quantize_matches_jax(dtype):
    """q, the scale and the new error bit for bit: x in fp32 or bf16 (the
    dequantisation in x's dtype), err in fp32."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 33)).astype(np.float32)
    err = (1e-2 * rng.standard_normal((64, 33))).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, scale, new_err = _ef_quantize(tx, torch.from_numpy(err))
    jq, jscale, jerr = jax_ef_quantize(jx, jnp.asarray(err))
    assert q.dtype == torch.int8 and new_err.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))


def test_cohort_all_reduce_equals_flat_equals_the_sum(ranks):
    """Rank r holds tree + r: every rank gets 4 x tree + 6, both ways."""
    _, out = ranks
    want = {"w": 4 * np.arange(24, dtype=np.float32).reshape(4, 6) + 6,
            "b": np.full((3,), 4 * 0.5 + 6, np.float32)}
    for rank in out:
        assert rank["backends"] == {"pod": "gloo", "data": "gloo", "world": "gloo"}
        for key, w in want.items():
            np.testing.assert_array_equal(rank["cohort"][key], w)
            np.testing.assert_array_equal(rank["flat"][key], w)


def test_counted_bytes_equal_the_formulas(ranks):
    """Per rank: the cohort's reduce-scatter and all-gather over data carry
    the padded fp32 bucket's share, the pod all-reduce only the fragment;
    flat all-reduces each leaf over the world."""
    _, out = ranks
    padded = 4 * (TREE_ELEMENTS + 1)
    for rank in out:
        assert rank["cohort_bytes"] == {
            "data": reduce_scatter_wire_bytes(padded, 2) + all_gather_wire_bytes(padded, 2),
            "pod": allreduce_wire_bytes(padded / 2, 2)}
        assert rank["flat_bytes"] == {"world": allreduce_wire_bytes(4 * 24, 4)
                                      + allreduce_wire_bytes(4 * 3, 4)}


def test_remote_class_carries_one_cohort_share(ranks):
    """A 64-element fp32 gradient: the pod hop of the cohort schedule
    carries 1/cohort of a pod all-reduce of the whole gradient, and the
    slow-fabric bytes of ``cohort_vs_flat_dcn_bytes``."""
    _, out = ranks
    grad = 64 * 4
    napkin = cohort_vs_flat_dcn_bytes(grad, pods=2, chips_per_pod=2)
    for rank in out:
        assert rank["even_cohort"]["pod"] == rank["even_pod"]["pod"] / 2
        assert rank["even_cohort"]["pod"] == napkin["cohort_dcn_bytes_per_chip"]
        assert rank["even_flat"]["world"] == napkin["flat_dcn_bytes_per_chip"]
        assert napkin["reduction"] == 3.0


def test_int8_error_feedback_converges(ranks):
    """tests/test_cohort_collectives.py's bounds: one exchange within the
    quantisation error, and the running mean of 24 well below it."""
    _, out = ranks
    for rank in out:
        errs = rank["ef_errors"]
        assert errs[0] < 0.05, errs[0]
        assert errs[-1] < errs[0] / 3, errs[::6]


def test_cost_model_headline_numbers():
    """The reference's napkin math: about 2 x the cohort at 2 pods of 256,
    and the slow fabric's time with it, on the H100's InfiniBand port."""
    r = cohort_vs_flat_dcn_bytes(16.1e9, pods=2, chips_per_pod=256)
    assert 500 < r["reduction"] < 520
    hw = H100()
    flat_s = hw.collective_time(r["flat_dcn_bytes_per_chip"], inter_node=True)
    coh_s = hw.collective_time(r["cohort_dcn_bytes_per_chip"], inter_node=True)
    assert coh_s < flat_s / 200
    assert hw.collective_time(1e9) < hw.collective_time(1e9, inter_node=True) / 8


def test_backend_rule():
    """NCCL only where every rank of a group has a GPU of its own."""
    assert group_backend([("a", "cuda:0"), ("a", "cuda:1")]) == "nccl"
    assert group_backend([("a", "cuda:0"), ("b", "cuda:0")]) == "nccl"
    assert group_backend([("a", "cuda:0"), ("a", "cuda:0")]) == "gloo"
    assert group_backend([("a", "cpu"), ("a", "cpu")]) == "gloo"
    assert group_backend([("a", "cuda:0"), ("a", "cpu")]) == "gloo"


def test_mesh_of_one_rank_and_refused_meshes():
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    assert mesh.world_size == 1 and mesh.coords == {"data": 0, "model": 0}
    t = torch.ones(3)
    assert mesh.all_reduce(t, "data") is t and not mesh.traffic.calls
    # Pods with FSDP and TP: the mesh is made by four ranks, with a group
    # per axis above 1 and the world's (a pair of axes spans a group of its
    # own only where all three are above 1).
    assert group_spans({"pod": 2, "data": 1, "model": 2}) == {
        "pod": ("pod",), "model": ("model",), "world": ("pod", "data", "model")}
    with pytest.raises(RuntimeError, match="initialised process group of 4"):
        make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="initialised process group of 2"):
        make_mesh((1, 2), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="initialised process group of 2"):
        make_mesh((2, 1), ("pod", "data"), "cpu")
    with pytest.raises(ValueError, match="distinct names"):
        make_mesh((2,), ("rows",), "cpu")
