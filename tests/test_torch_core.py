"""The port's core modules against ``ba_tpu``'s on random batches:
quorum, election, the strategy lie table, the OM(1) round and the
agreement step.  Tolerance is zero (integer outputs, bit-exact)."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core import election as j_election
from ba_tpu.core import om as j_om
from ba_tpu.core import quorum as j_quorum
from ba_tpu.core import state as j_state
from ba_tpu.core import types as j_types
from ba_tpu.parallel import sweep as j_sweep
from ba_tpu.scenario import spec as j_spec
from ba_tpu.scenario import strategies as j_strategies
from ba_tpu_torch import convert
from ba_tpu_torch.core import eig, election, om, quorum, rng, state, types
from ba_tpu_torch.parallel import sweep
from ba_tpu_torch.scenario import spec, strategies


def _eq(jax_value, torch_value):
    assert np.array_equal(np.asarray(jax_value), torch_value.cpu().numpy())


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _random_state(seed, B, n):
    rs = np.random.default_rng(seed)
    arrays = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=rs.integers(0, n, B).astype(np.int32),
        faulty=rs.random((B, n)) < 0.35,
        alive=rs.random((B, n)) < 0.8,
        ids=np.stack([rs.permutation(n) + 1 for _ in range(B)]).astype(np.int32),
    )
    arrays["alive"][0] = False  # an all-dead row
    jstate = j_state.SimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jstate, convert.state_from_numpy(jstate, "cpu"), rs


def test_command_codes_and_strategy_ids_match():
    assert (types.RETREAT, types.ATTACK, types.UNDEFINED) == (
        j_types.RETREAT, j_types.ATTACK, j_types.UNDEFINED)
    assert types.command_from_name("attack") == j_types.command_from_name("attack")
    assert types.command_from_name("Attack") == j_types.command_from_name("Attack")
    assert spec.STRATEGY_NAMES == j_spec.STRATEGY_NAMES
    for name in ("RANDOM", "COLLUDE_ATTACK", "COLLUDE_RETREAT", "SILENT", "ADAPTIVE_SPLIT"):
        assert getattr(strategies, name) == getattr(j_strategies, name)


@pytest.mark.parametrize("seed", range(3))
def test_quorum_matches(seed):
    rs = np.random.default_rng(seed)
    maj = rs.integers(0, 3, (64, 9)).astype(np.int8)
    alive = rs.random((64, 9)) < 0.6
    j_counts = j_quorum.majority_counts(jnp.asarray(maj), jnp.asarray(alive))
    t_counts = quorum.majority_counts(_t(maj), _t(alive))
    for a, b in zip(j_counts, t_counts):
        _eq(a, b)
    for a, b in zip(j_quorum.quorum_decision(*j_counts), quorum.quorum_decision(*t_counts)):
        _eq(a, b)
    total = np.arange(0, 40, dtype=np.int32)
    _eq(j_quorum.quorum_threshold(jnp.asarray(total)), quorum.quorum_threshold(_t(total)))
    a, r = rs.integers(0, 5, 50), rs.integers(0, 5, 50)
    _eq(j_quorum.strict_majority(jnp.asarray(a), jnp.asarray(r)),
        quorum.strict_majority(_t(a), _t(r)))


def test_zero_voters_and_ties():
    dec, needed, total = quorum.quorum_decision(
        torch.tensor([0, 1, 3, 1]), torch.tensor([0, 3, 1, 1]), torch.zeros(4, dtype=torch.int64))
    # zero voters never decide; a tie that meets the quorum prefers retreat
    assert dec.tolist() == [types.UNDEFINED, types.RETREAT, types.ATTACK, types.RETREAT]
    assert total.tolist() == [0, 4, 4, 2]
    assert needed.tolist() == [-1, 3, 3, 1]


@pytest.mark.parametrize("seed", range(3))
def test_election_matches_incl_all_dead_rows(seed):
    jstate, tstate, _ = _random_state(seed, 16, 11)
    got = election.elect_lowest_id(tstate.ids, tstate.alive)
    _eq(j_election.elect_lowest_id(jstate.ids, jstate.alive), got)
    assert got[0] == 0  # the all-dead row elects index 0


def test_lie_table_and_values_all_ids():
    ids = np.arange(-3, 9, dtype=np.int8)
    for dt_j, dt_t in ((jnp.int8, torch.int8), (jnp.int32, torch.int32)):
        for a, b in zip(j_strategies.lie_table(jnp.asarray(ids), dt_j),
                        strategies.lie_table(_t(ids), dt_t)):
            _eq(a, b)
    rs = np.random.default_rng(0)
    coins = rs.integers(0, 2, (12, 7)).astype(np.int8)
    recv = np.arange(7)[None, :]
    _eq(j_strategies.lie_values(jnp.asarray(ids)[:, None], jnp.asarray(coins), jnp.asarray(recv)),
        strategies.lie_values(_t(ids)[:, None], _t(coins), _t(recv)))


@pytest.mark.parametrize("with_strategies", [False, True])
@pytest.mark.parametrize("seed,B,n", [(0, 8, 1), (1, 12, 7), (2, 6, 13)])
def test_om1_round_from_coins_matches(seed, B, n, with_strategies):
    jstate, tstate, rs = _random_state(seed, B, n)
    c1 = rs.integers(0, 2, (B, n)).astype(np.int8)
    c2 = rs.integers(0, 2, (B, n, n)).astype(np.int8)
    strat = rs.integers(0, 6, (B, n)).astype(np.int8) if with_strategies else None
    js = None if strat is None else jnp.asarray(strat)
    ts = None if strat is None else _t(strat)
    j_recv = j_om.round1_apply(jstate, jnp.asarray(c1), js)
    t_recv = om.round1_apply(tstate, _t(c1), ts)
    _eq(j_recv, t_recv)
    j_ans = j_om.round2_apply(jstate, j_recv, jnp.asarray(c2), js)
    t_ans = om.round2_apply(tstate, t_recv, _t(c2), ts)
    _eq(j_ans, t_ans)
    _eq(j_om.tally_majorities(jstate, j_recv, j_ans), om.tally_majorities(tstate, t_recv, t_ans))
    _eq(j_om.om1_round_from_coins(jstate, jnp.asarray(c1), jnp.asarray(c2), js),
        om.om1_round_from_coins(tstate, _t(c1), _t(c2), ts))


@pytest.mark.parametrize("seed", range(3))
def test_om1_agreement_matches(seed):
    jstate, tstate, _ = _random_state(seed, 10, 9)
    j_out = j_om.om1_agreement(jr.key(seed), jstate)
    t_out = om.om1_agreement(rng.key(seed, device="cpu"), tstate)
    for name in ("majorities", "decision", "needed", "total", "n_attack", "n_retreat"):
        _eq(j_out[name], t_out[name])


@pytest.mark.parametrize("with_strategies", [False, True])
@pytest.mark.parametrize("seed,B,n", [(0, 5, 1), (1, 16, 6), (2, 9, 16)])
def test_agreement_step_matches(seed, B, n, with_strategies):
    jstate, tstate, rs = _random_state(seed, B, n)
    base_j, base_t = jr.key(seed + 40), rng.key(seed + 40, device="cpu")
    keys_j = jax.vmap(jr.fold_in, in_axes=(None, 0))(base_j, jnp.arange(B, dtype=jnp.uint32))
    keys_t = rng.fold_in(base_t[None, :], torch.arange(B))
    strat = rs.integers(0, 6, (B, n)).astype(np.int8) if with_strategies else None
    j_out = j_sweep.agreement_step(
        keys_j, jstate, strategies=None if strat is None else jnp.asarray(strat))
    t_out = sweep.agreement_step(keys_t, tstate, strategies=None if strat is None else _t(strat))
    for name in ("majorities", "decision", "needed", "total", "histogram"):
        _eq(j_out[name], t_out[name])


def test_agreement_step_is_om1_only():
    """Only m = 1 takes the coin-injected OM(1) path; m = 2 runs OM(2) by
    the EIG tree with one key a row (tests/test_torch_eig.py holds it to
    the reference), and a negative m raises."""
    _, tstate, _ = _random_state(0, 2, 4)
    keys = rng.fold_in(rng.key(0, device="cpu")[None], torch.arange(2))
    out = sweep.agreement_step(keys, tstate, m=2)
    _eq(eig.eig_round(keys, tstate, 2), out["majorities"])
    assert out["decision"].shape == (2,) and int(out["histogram"].sum()) == 2
    with pytest.raises(ValueError):
        sweep.agreement_step(keys, tstate, m=-1)


def test_make_state_matches():
    j = j_state.make_state(3, 5, order=j_types.ATTACK, faulty=jnp.array([0, 0, 1, 0, 0], bool))
    t = state.make_state(3, 5, order=types.ATTACK,
                         faulty=torch.tensor([0, 0, 1, 0, 0], dtype=torch.bool), device="cpu")
    for name, value in convert.state_to_numpy(t).items():
        assert np.array_equal(np.asarray(getattr(j, name)), value), name
    assert t.faulty.is_contiguous() and t.ids.is_contiguous()
