"""The port's SM coin helpers, round-1 broadcast, signed send gates and
SM(m) agreement on the collapsed and the exact relay against
``ba_tpu.core`` on the same keys: every output bit-equal, draws included
(tolerance zero, integer outputs)."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core import rng as jrng
from ba_tpu.core import sm as jsm
from ba_tpu.core.om import round1_broadcast as jax_round1
from ba_tpu.core.state import SimState as JaxState
from ba_tpu.crypto.signed import sig_valid_from_tables as jax_sig_valid
from ba_tpu.scenario import strategies as jstrategies
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng, sm
from ba_tpu_torch.core.om import round1_broadcast
from ba_tpu_torch.crypto.signed import sig_valid_from_tables
from ba_tpu_torch.scenario import strategies


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def mode(request):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    try:
        with rng.partitionable(request.param):
            yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _eq(jax_value, torch_value):
    want = np.asarray(jax_value)
    got = torch_value.numpy()
    assert want.shape == got.shape
    assert np.array_equal(want.astype(np.int64), got.astype(np.int64))


def _states(seed, B, n):
    """A random state with lieutenant traitors, faulty leaders in some
    instances, dead generals and random leaders: (jax, torch)."""
    rs = np.random.default_rng(seed)
    faulty = rs.random((B, n)) < 0.3
    faulty[::2, 0] = True
    arrays = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=np.where(rs.random(B) < 0.5, 0, rs.integers(0, n, B)).astype(np.int32),
        faulty=faulty,
        alive=rs.random((B, n)) < 0.85,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    jstate = JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jstate, convert.state_from_numpy(jstate, "cpu")


@pytest.mark.parametrize("shape", [(1,), (3,), (5, 7), (4, 9, 2)])
def test_uniform_u8(mode, shape):
    for seed in (0, 77):
        _eq(jrng.uniform_u8(jr.key(seed), shape),
            rng.uniform_u8(rng.key(seed, device="cpu"), shape))


def test_uniform_u8_batched_keys(mode):
    keys_j = jax.vmap(jr.fold_in, in_axes=(None, 0))(jr.key(3), jnp.arange(5, dtype=jnp.uint32))
    keys_t = rng.fold_in(rng.key(3, device="cpu")[None, :], torch.arange(5))
    _eq(jax.vmap(lambda k: jrng.uniform_u8(k, (6, 2)))(keys_j), rng.uniform_u8(keys_t, (6, 2)))


@pytest.mark.parametrize("gate", [False, True])
def test_or_coin_threshold8(gate):
    k = np.arange(13, dtype=np.int32)
    g = np.full(13, gate)
    _eq(jrng.or_coin_threshold8(jnp.asarray(k), jnp.asarray(g)),
        rng.or_coin_threshold8(torch.tensor(k), torch.tensor(g)))


@pytest.mark.parametrize("with_strategies", [False, True])
def test_round1_broadcast(mode, with_strategies):
    jstate, tstate = _states(1, 16, 11)
    strat = np.random.default_rng(2).integers(0, 6, (16, 11)).astype(np.int8)
    js = jnp.asarray(strat) if with_strategies else None
    ts = torch.tensor(strat) if with_strategies else None
    _eq(jax_round1(jr.key(4), jstate, js),
        round1_broadcast(rng.key(4, device="cpu"), tstate, ts))


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_sm_agreement_collapsed_signed(mode, m, seed):
    """The composition K2 fuses: round 1 under one subkey, the table
    verdicts' mask, the collapsed relay under the other."""
    B, n = 24, 19
    jstate, tstate = _states(seed, B, n)
    ok = np.random.default_rng(seed + 10).random((B, 2)) < 0.8
    jk = jr.key(seed + 100)
    tk = rng.key(seed + 100, device="cpu")
    jk1, jk2 = jr.split(jk)
    tk1, tk2 = rng.split(tk).unbind(-2)
    j_recv = jax_round1(jk1, jstate)
    t_recv = round1_broadcast(tk1, tstate)
    _eq(j_recv, t_recv)
    j_valid = jax_sig_valid(jnp.asarray(ok), j_recv)
    t_valid = sig_valid_from_tables(torch.tensor(ok), t_recv)
    want = jsm.sm_agreement(jk2, jstate, m, None, j_valid, j_recv, True)
    got = sm.sm_agreement(tk2, tstate, m, None, t_valid, t_recv, True)
    assert set(want) == set(got)
    for name in want:
        _eq(want[name], got[name])


@pytest.mark.parametrize("m", [0, 3])
def test_sm_agreement_draws_its_own_round1(mode, m):
    jstate, tstate = _states(5, 16, 33)
    want = jsm.sm_agreement(jr.key(9), jstate, m, collapsed=True)
    got = sm.sm_agreement(rng.key(9, device="cpu"), tstate, m, collapsed=True)
    for name in want:
        _eq(want[name], got[name])


def test_relay_and_choice_helpers(mode):
    jstate, tstate = _states(7, 12, 17)
    recv = np.random.default_rng(7).integers(0, 2, (12, 17)).astype(np.int8)
    j_seen = jsm._initial_seen(jstate, jnp.asarray(recv))
    t_seen = sm._initial_seen(tstate, torch.tensor(recv))
    _eq(j_seen, t_seen)
    j_out = jsm.sm_relay_rounds_collapsed(jr.key(2), jstate, j_seen, 3)
    t_out = sm.sm_relay_rounds_collapsed(rng.key(2, device="cpu"), tstate, t_seen, 3)
    _eq(j_out, t_out)
    _eq(jsm.choice_from_seen(j_out), sm.choice_from_seen(t_out))
    _eq(jsm.sm_choice(jstate, j_out), sm.sm_choice(tstate, t_out))


def test_exact_relay_paths_are_queued():
    """The exact relay is ported; what stays refused is what the
    reference refuses: the collapsed relay with a withhold schedule or
    strategies, and the exact one with both."""
    _, tstate = _states(0, 2, 4)
    k = rng.key(0, device="cpu")
    assert sm.sm_agreement(k, tstate, 1)["decision"].shape == (2,)
    with pytest.raises(ValueError, match="withhold"):
        sm.sm_agreement(k, tstate, 1, withhold=torch.zeros(1), collapsed=True)
    with pytest.raises(ValueError, match="strategies"):
        sm.sm_agreement(k, tstate, 1, collapsed=True,
                        strategies=torch.zeros((2, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="strategies"):
        sm.sm_agreement(k, tstate, 1, withhold=torch.zeros((1, 2, 4, 4, 2), dtype=torch.bool),
                        strategies=torch.zeros((2, 4), dtype=torch.int8))


def test_send_gate_every_strategy():
    """Every id (the five strategies and unknown ones) against every coin,
    receiver parity and value."""
    strat = np.arange(-1, 7, dtype=np.int8)[:, None, None, None]
    coins = np.array([False, True])[None, :, None, None]
    recv = np.arange(4, dtype=np.int32)[None, None, :, None]
    value = np.arange(2, dtype=np.int32)[None, None, None, :]
    want = jstrategies.send_gate(*(jnp.asarray(a) for a in (strat, coins, recv, value)))
    got = strategies.send_gate(*(torch.tensor(a) for a in (strat, coins, recv, value)))
    assert got.shape == (8, 2, 4, 2)
    _eq(want, got)


def _exact_case(seed, B, n, m, kind):
    """Inputs of one exact-relay case: states, key, and the withhold
    schedule or the strategies (jax, torch) when ``kind`` asks for them."""
    jstate, tstate = _states(seed, B, n)
    rs = np.random.default_rng(seed + 50)
    extra = {}
    if kind == "withhold":
        w = rs.random((m, B, n, n, 2)) < 0.5
        extra = (dict(withhold=jnp.asarray(w)), dict(withhold=torch.tensor(w)))
    elif kind == "strategies":
        st = rs.integers(0, 6, (B, n)).astype(np.int8)
        extra = (dict(strategies=jnp.asarray(st)), dict(strategies=torch.tensor(st)))
    else:
        extra = ({}, {})
    return jstate, tstate, extra


@pytest.mark.parametrize("kind", ["coins", "withhold", "strategies"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_sm_relay_rounds_exact(mode, m, kind):
    B, n = 12, 11
    jstate, tstate, (jx, tx) = _exact_case(m, B, n, m, kind)
    recv = np.random.default_rng(m).integers(0, 2, (B, n)).astype(np.int8)
    j_seen = jsm._initial_seen(jstate, jnp.asarray(recv))
    t_seen = sm._initial_seen(tstate, torch.tensor(recv))
    want = jsm.sm_relay_rounds(jr.key(m + 40), jstate, j_seen, m, **jx)
    got = sm.sm_relay_rounds(rng.key(m + 40, device="cpu"), tstate, t_seen, m, **tx)
    _eq(want, got)


@pytest.mark.parametrize("kind", ["coins", "withhold", "strategies"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_sm_agreement_exact(mode, m, kind):
    """The whole exact SM(m) round: round 1 (strategies shape it too),
    the signature mask, the relay cube, the choice and the quorum."""
    B, n = 16, 16
    jstate, tstate, (jx, tx) = _exact_case(m + 7, B, n, m, kind)
    ok = np.random.default_rng(m).random((B, n)) < 0.9
    want = jsm.sm_agreement(jr.key(m + 60), jstate, m, sig_valid=jnp.asarray(ok), **jx)
    got = sm.sm_agreement(rng.key(m + 60, device="cpu"), tstate, m,
                          sig_valid=torch.tensor(ok), **tx)
    assert set(want) == set(got)
    for name in want:
        _eq(want[name], got[name])
