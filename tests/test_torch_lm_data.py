"""The port's synthetic LM token pipeline vs ``repro.data.lm``: every batch
bit for bit (numpy on both sides), across steps, seeds and data-parallel
shards, and the iterator's order."""

import itertools

import numpy as np
import pytest

from repro.data import lm as jax_lm
from repro_torch.data import lm


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_batch_is_the_references(seed, num_shards):
    cfg = lm.LMDataConfig(vocab=1000, batch=8, seq_len=33, seed=seed)
    ref = jax_lm.LMDataConfig(vocab=1000, batch=8, seq_len=33, seed=seed)
    for step in (0, 1, 17):
        for shard in range(num_shards):
            got = lm.sample_batch(cfg, step, shard, num_shards)
            want = jax_lm.sample_batch(ref, step, shard, num_shards)
            assert got.keys() == want.keys() == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
            assert got["tokens"].shape == (8 // num_shards, 33)


def test_shards_are_disjoint_slices_and_labels_shift():
    cfg = lm.LMDataConfig(vocab=50_000, batch=4, seq_len=16, structure=50_000)
    whole = lm.sample_batch(cfg, 3)
    parts = [lm.sample_batch(cfg, 3, s, 2) for s in range(2)]
    np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts]), whole["tokens"])
    np.testing.assert_array_equal(whole["tokens"][:, 1:], whole["labels"][:, :-1])


def test_splitmix64_and_iterator_are_the_references():
    x = np.arange(0, 2**20, 977, dtype=np.uint64)
    np.testing.assert_array_equal(lm._splitmix64(x), jax_lm._splitmix64(x))
    cfg = lm.LMDataConfig(vocab=300, batch=2, seq_len=5)
    ref = jax_lm.LMDataConfig(vocab=300, batch=2, seq_len=5)
    for got, want in zip(itertools.islice(lm.batch_iterator(cfg, 4, 1, 2), 3),
                         itertools.islice(jax_lm.batch_iterator(ref, 4, 1, 2), 3)):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
