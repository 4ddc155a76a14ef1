"""The port's threefry2x32 draws against ``jax.random``, bit for bit.

The reference draws its search seeds, its initial k-NN lists and its
bridge hubs with ``jax.random`` (jax's default threefry2x32,
``jax_threefry_partitionable=True``); the port recomputes them with
:mod:`repro_torch.core.prng`, which is what lets the search tests compare
ids and not only recall.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)


def _key_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_key(seed):
    assert np.array_equal(prng.key(seed).numpy(),
                          _key_data(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_fold_in_scalar(data):
    k = jax.random.key(3)
    assert np.array_equal(prng.fold_in(prng.key(3), data).numpy(),
                          _key_data(jax.random.fold_in(k, data)))


def test_fold_in_batched_rows():
    """vmap of fold_in over row ids == one broadcast call."""
    k = jax.random.fold_in(jax.random.key(0), 5)
    rows = jnp.arange(100)
    ref = _key_data(jax.vmap(lambda i: jax.random.fold_in(k, i))(rows))
    ours = prng.fold_in(prng.fold_in(prng.key(0), 5), torch.arange(100))
    assert np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("num", [2, 3])
def test_split(num):
    k = jax.random.key(11)
    assert np.array_equal(prng.split(prng.key(11), num).numpy(),
                          _key_data(jax.random.split(k, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (4, 33)])
def test_random_bits(shape):
    k = jax.random.key(2)
    ref = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.random_bits(prng.key(2), shape).numpy(), ref)


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 2), (0, 256), (0, 1000),
                                   (0, 1_048_576), (0, 1_000_003),
                                   (0, 2 ** 31 - 1), (5, 17)])
def test_randint(lo, hi):
    k = jax.random.key(9)
    ref = np.asarray(jax.random.randint(k, (6, 5), lo, hi, jnp.int32))
    ours = prng.randint(prng.key(9), (6, 5), lo, hi)
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("n,m", [(100, 25), (1625, 256), (2000, 500),
                                 (70_000, 256)])
def test_choice_without_replacement(n, m):
    """One sort round below n ~ 1625, two above (the reference's shuffle)."""
    ref = np.asarray(jax.random.choice(jax.random.key(0), n, (m,),
                                       replace=False))
    ours = prng.choice(prng.key(0), n, (m,))
    assert np.array_equal(ours.numpy(), ref)
    assert len(set(ours.tolist())) == m


def test_choice_rejects_oversampling():
    with pytest.raises(ValueError):
        prng.choice(prng.key(0), 4, (5,))


def test_small_search_seed_draws():
    """The exact calls of search_small.py:134-156 (row keys folded from a
    global row index, seeds, then hub picks)."""
    N, S, t0, n_seeds, nh = 5000, 24, 4, 8, 37
    key = jax.random.fold_in(jax.random.key(0), 0)
    flat = jnp.arange(S)
    row_ids = (flat // t0) * t0 + flat % t0
    rk = jax.vmap(lambda i: jax.random.fold_in(key, i))(row_ids)
    seeds = jax.vmap(lambda r: jax.random.randint(r, (n_seeds,), 0, N,
                                                  jnp.int32))(rk)
    hub = jax.vmap(lambda r: jax.random.randint(
        jax.random.fold_in(r, 1), (n_seeds // 2,), 0, nh))(rk)
    trk = prng.fold_in(prng.fold_in(prng.key(0), 0), torch.arange(S))
    assert np.array_equal(prng.randint(trk, (n_seeds,), 0, N).numpy(),
                          np.asarray(seeds))
    assert np.array_equal(
        prng.randint(prng.fold_in(trk, 1), (n_seeds // 2,), 0, nh).numpy(),
        np.asarray(hub))


def test_knn_init_and_bridge_draws():
    """knn_build.py:96-99 and diversify.py:262-272."""
    N, k = 3000, 8
    ref = np.asarray(jax.random.randint(jax.random.key(0), (N, k), 0, N,
                                        jnp.int32))
    assert np.array_equal(prng.randint(prng.key(0), (N, k), 0, N).numpy(),
                          ref)
    key = jax.random.key(0)
    rnd = np.asarray(jax.random.randint(jax.random.fold_in(key, 7), (64, 4),
                                        0, 64))
    ours = prng.randint(prng.fold_in(prng.key(0), 7), (64, 4), 0, 64)
    assert np.array_equal(ours.numpy(), rnd)
