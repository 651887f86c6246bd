"""The port's threefry (sbsim_tpu_torch.rng) is bitwise jax.random."""

import jax
import numpy as np
import pytest
import torch

from sbsim_tpu_torch import rng


def _keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789, 2**31 - 1, -1, -(2**31)])
def test_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = rng.PRNGKey(seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("num", [2, 3, 4, 7])
def test_split_batched(num):
    keys = _keys([0, 5, 2**31 - 1, -7])
    want = np.stack([np.asarray(jax.random.split(k, num)) for k in keys])
    got = rng.split(torch.as_tensor(keys.astype(np.int64)), num).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_split_chains_like_the_env():
    """Repeated 4-way splits of split keys (the step's key schedule)."""
    key = jax.random.PRNGKey(3)
    tkey = rng.PRNGKey(3)
    for _ in range(5):
        key = jax.random.split(key, 4)[0]
        tkey = rng.split(tkey, 4)[0]
        np.testing.assert_array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("shape", [(12, 1), (126, 1), (3, 5), (1,), (1000,)])
def test_uniform_and_bits_batched(shape):
    keys = _keys([1, 9, 77])
    tkeys = torch.as_tensor(keys.astype(np.int64))
    want = np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])
    got = rng.uniform(tkeys, shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    want_bits = np.stack(
        [np.asarray(jax.random.bits(k, shape, dtype=np.uint32)) for k in keys]
    )
    np.testing.assert_array_equal(rng.bits(tkeys, shape).numpy(),
                                  want_bits.astype(np.int64))


def test_prng_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        rng.PRNGKey(2**31)
