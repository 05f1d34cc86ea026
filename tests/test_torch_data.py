"""The port's data pipeline: the reference's own cases (``tests/test_data.py``)
against the port, and batches bit-identical to the JAX package's for the
same ``(seed, index, host)``."""

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import SyntheticLMDataset, make_batch_iterator

CFG = get_config("llama3.2-1b", smoke=True)
SHAPE = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")


def test_batches_deterministic():
    d1 = SyntheticLMDataset(CFG, SHAPE, seed=3)
    d2 = SyntheticLMDataset(CFG, SHAPE, seed=3)
    b1, b2 = d1.batch(5), d2.batch(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["labels"], b2["labels"])


def test_different_steps_differ():
    d = SyntheticLMDataset(CFG, SHAPE, seed=3)
    assert not np.array_equal(d.batch(0)["tokens"], d.batch(1)["tokens"])


def test_labels_are_next_tokens():
    b = SyntheticLMDataset(CFG, SHAPE, seed=0).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_markov_structure_learnable():
    """Every (cur -> next) transition is one of the 4 designated successors."""
    d = SyntheticLMDataset(CFG, SHAPE, seed=0, branching=4)
    b = d.batch(0)
    cur, nxt = b["tokens"][:, :-1].ravel(), b["tokens"][:, 1:].ravel()
    assert np.any(d.successors[cur] == nxt[:, None], axis=1).all()


def test_host_shards_partition_global_batch():
    d = SyntheticLMDataset(CFG, SHAPE, seed=1)
    parts = [d.batch(2, host=h, num_hosts=4) for h in range(4)]
    assert all(p["tokens"].shape[0] == SHAPE.global_batch // 4 for p in parts)
    assert not np.array_equal(parts[0]["tokens"], parts[1]["tokens"])


def test_uneven_host_split_is_refused():
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLMDataset(CFG, SHAPE).batch(0, host=0, num_hosts=3)


def test_iterator_resumes_at_step():
    d = SyntheticLMDataset(CFG, SHAPE, seed=1)
    it = make_batch_iterator(d, start_step=10)
    first, second = next(it), next(it)
    it.close()
    np.testing.assert_array_equal(first["tokens"], d.batch(10)["tokens"])
    np.testing.assert_array_equal(second["tokens"], d.batch(11)["tokens"])


def test_vlm_and_audio_batches():
    vcfg = get_config("internvl2-76b", smoke=True)
    vb = SyntheticLMDataset(vcfg, SHAPE, seed=0).batch(0)
    assert vb["embeds"].shape == (8, vcfg.frontend_tokens, vcfg.d_model)
    assert vb["tokens"].shape[1] == SHAPE.seq_len - vcfg.frontend_tokens
    acfg = get_config("hubert-xlarge", smoke=True)
    ab = SyntheticLMDataset(acfg, SHAPE, seed=0).batch(0)
    assert ab["embeds"].shape == (8, SHAPE.seq_len, acfg.d_model)
    assert ab["labels"].shape == (8, SHAPE.seq_len)


@pytest.mark.parametrize("arch,seed,index,host,num_hosts", [
    ("llama3.2-1b", 0, 0, 0, 1),
    ("llama3.2-1b", 7, 123, 1, 2),
    ("recurrentgemma-9b", 3, 5, 3, 4),
    ("internvl2-76b", 1, 2, 0, 1),
    ("hubert-xlarge", 2, 9, 1, 4),
])
def test_batches_bit_identical_to_jax(arch, seed, index, host, num_hosts):
    shape = ShapeConfig("t", seq_len=40, global_batch=8, kind="train")
    got = SyntheticLMDataset(get_config(arch, smoke=True), shape, seed=seed)
    want = JaxDataset(jax_config(arch, smoke=True), shape, seed=seed)
    np.testing.assert_array_equal(got.successors, want.successors)
    a, b = got.batch(index, host, num_hosts), want.batch(index, host, num_hosts)
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


def test_full_width_llama_batch_identical_to_jax():
    """At the published vocabulary (128256) and the train_4k length."""
    shape = ShapeConfig("train_4k", seq_len=4096, global_batch=2, kind="train")
    a = SyntheticLMDataset(get_config("llama3.2-1b"), shape).batch(4)
    b = JaxDataset(jax_config("llama3.2-1b"), shape).batch(4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].max() < 128256 and a["tokens"].shape == (2, 4096)
