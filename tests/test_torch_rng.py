"""ops/rng.py: threefry bits equal to jax.random's (partitionable
threefry, the jax 0.9 default)."""

import jax
import numpy as np
import pytest
import torch

from bhraytracer_tpu_torch.ops import rng

torch.set_num_threads(2)


def _bits(x):
    return np.asarray(x).view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2 ** 31 - 1])
def test_key_and_fold_in_chain(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.prng_key(seed)
    np.testing.assert_array_equal(_bits(jk), tk.numpy())
    for data in (0, 1, 2, 40, 100, 105, 0x5EED, 479999, 2 ** 32 - 1):
        jk, tk = jax.random.fold_in(jk, data), rng.fold_in(tk, data)
        np.testing.assert_array_equal(_bits(jk), tk.numpy())


@pytest.mark.parametrize("shape", [(1,), (5, 13), (1000, 13), (333, 2), (7, 3, 4)])
def test_uniform_bits(shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    tk = rng.fold_in(rng.prng_key(3), 11)
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = rng.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32 and tu.shape == ju.shape
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))


@pytest.mark.parametrize("sample,start,level", [(0, 0, 0), (1, 768, 2),
                                                 (3, 480000, 5)])
def test_integrator_key_chain(sample, start, level):
    """The chunk key of pathtracer.py:1151, the level key of :1346 and the
    draws made from them: raygen jitter (:1120), the level's (n,13) table
    (:703) and the chain keys (:818, :479-481)."""
    from bhraytracer_tpu_torch.models.pathtracer import _level_key

    jbase, tbase = jax.random.PRNGKey(0), rng.prng_key(0)
    jck = jax.random.fold_in(jax.random.fold_in(jbase, sample), start)
    tck = rng.fold_in(rng.fold_in(tbase, sample), start)
    np.testing.assert_array_equal(_bits(jck), tck.numpy())
    jl = jax.random.fold_in(jax.random.fold_in(jck, 1), 100 + level)
    tl = _level_key(tck, level)
    np.testing.assert_array_equal(_bits(jl), tl.numpy())
    for jkey, tkey, shape in (
            (jax.random.fold_in(jck, 0), rng.fold_in(tck, 0), (300, 2)),
            (jax.random.fold_in(jl, 1), rng.fold_in(tl, 1), (300, 13))):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jkey, shape)).view(np.uint32),
            rng.uniform(tkey, shape).numpy().view(np.uint32))
    jchain = jax.random.fold_in(jax.random.fold_in(jl, 2), 40)
    tchain = rng.fold_in(rng.fold_in(tl, 2), 40)
    np.testing.assert_array_equal(_bits(jax.random.fold_in(jchain, 3)),
                                  rng.fold_in(tchain, 3).numpy())


def test_batched_keys_match_one_by_one():
    """The glossy-refraction draws take 2*tries streams in one call."""
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 2)
    tk = rng.fold_in(rng.prng_key(9), 2)
    tags = torch.arange(20, 28)
    batch = rng.uniform(rng.fold_in(tk, tags), (257,)).numpy()
    for row, tag in enumerate(tags.tolist()):
        ju = np.asarray(jax.random.uniform(jax.random.fold_in(jk, tag), (257,)))
        np.testing.assert_array_equal(batch[row].view(np.uint32),
                                      ju.view(np.uint32))


def test_row_draws_match_the_table():
    """uniform_rows draws given rows of a table from their counters alone:
    bit for bit jax.random.uniform(key, (N, k))[rows] and uniform(key,
    (N, k))[rows], and for a key batch, the columns `rows` of each key's
    (N,) draw (rows in any order, repeated, none)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(5), 101)
    tk = rng.fold_in(rng.prng_key(5), 101)
    rows = np.array([977, 0, 5, 5, 512, 999, 1], np.int64)
    tr = torch.from_numpy(rows)
    for k in (13, 2):
        ju = np.asarray(jax.random.uniform(jk, (1000, k)))[rows]
        got = rng.uniform_rows(tk, tr, k).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), ju.view(np.uint32))
        np.testing.assert_array_equal(
            got.view(np.uint32),
            rng.uniform(tk, (1000, k))[tr].numpy().view(np.uint32))
    tags = torch.arange(20, 26)
    batch = rng.uniform_rows(rng.fold_in(tk, tags), tr).numpy()
    assert batch.shape == (6, rows.shape[0])
    for row, tag in enumerate(tags.tolist()):
        ju = np.asarray(jax.random.uniform(jax.random.fold_in(jk, tag),
                                           (1000,)))[rows]
        np.testing.assert_array_equal(batch[row].view(np.uint32),
                                      ju.view(np.uint32))
    assert rng.uniform_rows(tk, tr[:0], 13).shape == (0, 13)
