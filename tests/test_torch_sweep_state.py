"""The port's sweep-state samplers (``make_sweep_state``,
``bucketed_sweep_states``) and the draws behind them (``randint``,
``uniform``) against ``ba_tpu.parallel`` and ``jax.random``, bit-exact,
in both threefry modes.  Tolerance: zero (integer, boolean and float32
bit patterns)."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.parallel import bucketed_sweep_states as jax_buckets
from ba_tpu.parallel import make_sweep_state as jax_make
from ba_tpu_torch.core import rng
from ba_tpu_torch.parallel import sweep

FIELDS = ("order", "leader", "faulty", "alive", "ids")


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


def _same_state(a, b):
    for name in FIELDS:
        want = np.asarray(getattr(a, name))
        got = getattr(b, name).numpy()
        assert want.shape == got.shape, name
        assert np.array_equal(want.astype(got.dtype), got), name


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
@pytest.mark.parametrize("frac", [0.0, 0.2, 1 / 3])
@pytest.mark.parametrize("batch,capacity", [(16, 16), (8, 1024)])
def test_make_sweep_state(mode, seed, frac, batch, capacity):
    want = jax_make(jr.key(seed), batch, capacity, max_traitor_frac=frac)
    got = sweep.make_sweep_state(rng.key(seed, device="cpu"), batch, capacity,
                                 max_traitor_frac=frac)
    _same_state(want, got)


def test_make_sweep_state_size_range_and_order(mode):
    want = jax_make(jr.key(3), 32, 64, min_n=10, max_n=20, order=0)
    got = sweep.make_sweep_state(rng.key(3, device="cpu"), 32, 64, min_n=10, max_n=20,
                                 order=0)
    _same_state(want, got)
    with pytest.raises(ValueError):
        sweep.make_sweep_state(rng.key(3, device="cpu"), 4, 8, min_n=9)


@pytest.mark.parametrize("n_buckets", [1, 2, 4])
@pytest.mark.parametrize("seed", [5, 11])
def test_bucketed_sweep_states(mode, seed, n_buckets):
    want = jax_buckets(jr.key(seed), 30, 512, n_buckets)
    got = sweep.bucketed_sweep_states(rng.key(seed, device="cpu"), 30, 512, n_buckets)
    assert len(want) == len(got) == n_buckets
    for a, b in zip(want, got):
        _same_state(a, b)


def test_bucketed_small_capacity_and_errors(mode):
    want = jax_buckets(jr.key(1), 9, 16, 2, max_traitor_frac=0.2)
    got = sweep.bucketed_sweep_states(rng.key(1, device="cpu"), 9, 16, 2,
                                      max_traitor_frac=0.2)
    for a, b in zip(want, got):
        _same_state(a, b)
    with pytest.raises(ValueError):
        sweep.bucketed_sweep_states(rng.key(1, device="cpu"), 9, 16, 8)


@pytest.mark.parametrize("minval,maxval", [
    (0, 1),       # span 1
    (5, 5),       # maxval == minval: span 1, minval comes back
    (9, 3),       # maxval < minval
    (-7, 100),
    (0, 2**31 - 1),
    (-2**31, 2**31 - 1),
])
def test_randint_edge_spans(mode, minval, maxval):
    for seed in (0, 99):
        want = jr.randint(jr.key(seed), (13,), minval, maxval)
        got = rng.randint(rng.key(seed, device="cpu"), (13,), minval, maxval)
        assert np.array_equal(np.asarray(want), got.numpy())


def test_randint_per_row_maxval(mode):
    maxval = np.array([1, 2, 3, 17, 0, 1000, 5], np.int32)
    want = jr.randint(jr.key(4), (7,), 0, jnp.asarray(maxval))
    got = rng.randint(rng.key(4, device="cpu"), (7,), 0, torch.tensor(maxval))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 17)])
def test_uniform(mode, shape):
    for seed in (0, 1234):
        want = np.asarray(jr.uniform(jr.key(seed), shape))
        got = rng.uniform(rng.key(seed, device="cpu"), shape)
        assert got.dtype == torch.float32
        assert np.array_equal(want.view(np.uint32), got.numpy().view(np.uint32))
