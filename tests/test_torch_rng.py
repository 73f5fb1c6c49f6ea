"""The port's threefry2x32 and coin streams against jax.random and
``ba_tpu.core.rng``, bit-exact, in both threefry modes."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core import rng as jrng
from ba_tpu_torch.core import rng

SEEDS = (0, 1234, 2**31, 2**32 + 5)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def mode(request):
    """Run the test under one threefry mode in both packages, then
    restore jax's setting and the port's flag."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    try:
        with rng.partitionable(request.param):
            yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _pair(seed):
    return jr.key(seed), rng.key(seed, device="cpu")


def _eq(jax_value, torch_value):
    assert np.array_equal(np.asarray(jax_value).astype(np.int64), torch_value.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(mode, seed):
    jk, tk = _pair(seed)
    _eq(jr.key_data(jk), rng.key_data(tk))
    for d in (0, 1, 77, 2**32 - 1):
        _eq(jr.key_data(jr.fold_in(jk, d)), rng.fold_in(tk, d))
    for num in (2, 3):
        _eq(jr.key_data(jr.split(jk, num)), rng.split(tk, num))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", [1, 2, 3, 7, 8, 33])
def test_bits(mode, seed, size):
    jk, tk = _pair(seed)
    _eq(jr.bits(jk, (size,), jnp.uint32), rng.bits(tk, (size,)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (37,), (2, 5), (5, 7), (16, 16)])
def test_coins(mode, seed, shape):
    jk, tk = _pair(seed)
    size = int(np.prod(shape))
    _eq(jrng.coin_bits(jk, shape), rng.coin_bits(tk, shape))
    words = rng.coin_words(tk, size)  # ba-lint: disable=BA202 (two views of one stream)
    _eq(jrng.coin_words(jk, size), words)
    _eq(jrng.unpack_coin_words(jrng.coin_words(jk, size), shape),
        rng.unpack_coin_words(words, shape))
    _eq(jrng.coin_bits(jk, shape), rng.unpack_coin_words(words, shape))


def test_batched_keys_match_per_key_draws(mode):
    base_j, base_t = _pair(99)
    keys_j = jax.vmap(jr.fold_in, in_axes=(None, 0))(base_j, jnp.arange(6, dtype=jnp.uint32))
    keys_t = rng.fold_in(base_t[None, :], torch.arange(6))
    _eq(jr.key_data(keys_j), keys_t)
    _eq(jr.key_data(jax.vmap(jr.split)(keys_j)), rng.split(keys_t))
    _eq(jax.vmap(lambda k: jrng.coin_bits(k, (3, 5)))(keys_j), rng.coin_bits(keys_t, (3, 5)))


def test_known_answers():
    assert jax.config.jax_threefry_partitionable
    assert rng.threefry_partitionable()
    k = rng.key(1234, device="cpu")
    assert k.tolist() == [0, 1234]
    assert rng.split(k).tolist() == [[1264997412, 2518116175], [2877103387, 1697627890]]
    assert rng.fold_in(k, 1).tolist() == [2877103387, 1697627890]
    assert rng.bits(k, (3,)).tolist() == [3715183467, 3461522409, 1578076316]
    assert rng.coin_bits(k, (2, 5)).tolist() == [[1, 1, 0, 1, 0], [1, 1, 0, 1, 1]]  # ba-lint: disable=BA202 (known answers)
    assert rng.key(2**32 + 5, device="cpu").tolist() == [0, 5]


def test_int32_counter_folds_as_uint32():
    jk, tk = _pair(7)
    _eq(jr.key_data(jr.fold_in(jk, jnp.int32(-3))),
        rng.fold_in(tk, torch.tensor(-3, dtype=torch.int32)))
