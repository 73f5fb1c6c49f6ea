"""The plain version of K2 (``ba_tpu_torch.ops.sweep_step``) against the
JAX package's XLA composition of the signed sweep step, on the
reference's own K2 contract (``tests/test_ops.py``'s fused-sweep tests):
bit-exact where no draw can matter, equal in decision histograms
otherwise.  The JAX side runs its XLA engine: the Pallas body of K2
draws from the TPU's hardware PRNG, which has no CPU form.

Tolerance: zero for every exact comparison (integer decisions); the
histogram bands are the reference's 6 * sqrt(B) per bin.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core import sm_agreement
from ba_tpu.core.om import round1_broadcast
from ba_tpu.core.types import ATTACK, UNDEFINED
from ba_tpu.crypto.signed import sig_valid_from_tables
from ba_tpu.parallel import make_sweep_state
from ba_tpu_torch import convert
from ba_tpu_torch.ops import sweep_step


def _xla_sweep_step(key, state, ok, m):
    """The composition the kernel fuses (bench.py's one_bucket)."""
    k1, k2 = jr.split(key)
    received = round1_broadcast(k1, state)
    sig_valid = sig_valid_from_tables(ok, received)
    return np.asarray(sm_agreement(k2, state, m, None, sig_valid, received, True)["decision"])


def _plain(seed, state, ok, m, rounds=1):
    st = convert.state_from_numpy(state, "cpu")
    out = sweep_step.fused_signed_sweep_step(
        torch.tensor([seed], dtype=torch.int32), st.order, st.leader, st.faulty, st.alive,
        torch.tensor(np.array(ok)), m, rounds)
    return out.numpy()


def _faulty_leaders(state):
    faulty = np.array(state.faulty)
    faulty[:, 0] = True  # every leader equivocates
    return type(state)(state.order, state.leader, jnp.asarray(faulty), state.alive, state.ids)


@pytest.mark.parametrize("rounds", [1, 6, 35])
def test_no_traitors_bit_exact(rounds):
    B, cap, m = 64, 128, 3
    state = make_sweep_state(jr.key(0), B, cap, max_traitor_frac=0.0)
    ok = jnp.ones((B, 2), bool)
    want = _xla_sweep_step(jr.key(1), state, ok, m)
    got = _plain(3, state, ok, m, rounds)
    if rounds == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert got.shape == (B, rounds)
        for r in range(rounds):
            np.testing.assert_array_equal(got[:, r], want)


def test_invalid_signatures_undefined():
    B, cap, m = 64, 128, 2
    state = make_sweep_state(jr.key(2), B, cap)
    ok = jnp.zeros((B, 2), bool)
    assert (_plain(5, state, ok, m) == UNDEFINED).all()
    assert (_xla_sweep_step(jr.key(2), state, ok, m) == UNDEFINED).all()


def test_honest_leader_validity():
    B, cap, m = 64, 64, 3
    state = make_sweep_state(jr.key(4), B, cap, max_traitor_frac=0.2)
    assert np.asarray(state.faulty).any()
    ok = jnp.ones((B, 2), bool)
    want = _xla_sweep_step(jr.key(5), state, ok, m)
    got = _plain(6, state, ok, m, rounds=3)
    assert (want == ATTACK).all()
    assert (got == ATTACK).all()


@pytest.mark.parametrize("rounds", [1, 4])
def test_faulty_leader_histograms_match_xla(rounds):
    B, cap, m = 8192, 16, 2
    state = _faulty_leaders(make_sweep_state(jr.key(8), B, cap))
    ok = jnp.ones((B, 2), bool)
    h_want = np.bincount(_xla_sweep_step(jr.key(9), state, ok, m), minlength=3)
    got = _plain(10, state, ok, m, rounds).reshape(B, rounds)
    band = 6 * np.sqrt(B)
    assert len(np.unique(got)) > 1  # equivocation is visible
    for r in range(rounds):
        h_got = np.bincount(got[:, r], minlength=3)
        assert (np.abs(h_want - h_got) < band).all(), (r, h_want, h_got)


def test_rounds_are_independent_and_seeded():
    B, cap, m, R = 512, 16, 2, 4
    state = _faulty_leaders(make_sweep_state(jr.key(35), B, cap))
    ok = jnp.ones((B, 2), bool)
    multi = _plain(37, state, ok, m, R)
    assert any((multi[:, r] != multi[:, 0]).any() for r in range(1, R))
    assert (_plain(38, state, ok, m, R) != multi).any()


def test_first_column_equals_single_round():
    B, cap, m = 256, 64, 3
    state = _faulty_leaders(make_sweep_state(jr.key(30), B, cap))
    ok = jnp.ones((B, 2), bool)
    single = _plain(31, state, ok, m)
    multi = _plain(31, state, ok, m, 8)
    assert multi.shape == (B, 8)
    np.testing.assert_array_equal(multi[:, 0], single)


@pytest.mark.parametrize("bad", [0, 1921])
def test_rounds_out_of_range(bad):
    o = torch.zeros(8, dtype=torch.int8)
    ldr = torch.zeros(8, dtype=torch.int32)
    f = torch.zeros((8, 16), dtype=torch.bool)
    ok = torch.ones((8, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="rounds"):
        sweep_step.fused_signed_sweep_step(torch.tensor([1], dtype=torch.int32),
                                           o, ldr, f, f, ok, 1, bad)


@pytest.mark.parametrize("words,want", [
    ((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 6, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(words, want):
    """Random123's known answers for Philox4x32-10 (counter, then key)."""
    assert tuple(int(w) for w in sweep_step.philox4x32_10(*words)) == want


def test_plain_draws_do_not_depend_on_batch_layout():
    """Instance b's stream is keyed by (seed, b): a prefix of the batch
    decides as it does inside the whole batch."""
    B, cap, m = 96, 32, 3
    state = _faulty_leaders(make_sweep_state(jr.key(12), B, cap))
    rs = np.random.default_rng(0)
    ok = jnp.asarray(rs.random((B, 2)) < 0.8)
    whole = _plain(13, state, ok, m, 5)
    sub = type(state)(*(np.asarray(x)[:40] for x in
                        (state.order, state.leader, state.faulty, state.alive, state.ids)))
    np.testing.assert_array_equal(_plain(13, sub, np.asarray(ok)[:40], m, 5), whole[:40])


def test_plain_counts_only_the_draws_that_matter(monkeypatch):
    """Honest leaders with valid tables need no draw, so the plain version
    computes no Philox block; faulty leaders need one block a round (at
    m = 3 draws 0-3 share block 0), at counter (round, general, 0, 0)."""
    B, cap, m, R = 32, 64, 3, 3
    calls = []
    real = sweep_step.philox4x32_10

    def counting(*words):
        calls.append(words)
        return real(*words)

    monkeypatch.setattr(sweep_step, "philox4x32_10", counting)
    state = make_sweep_state(jr.key(14), B, cap)
    st = convert.state_from_numpy(state, "cpu")
    seed = torch.tensor([1], dtype=torch.int32)
    ok = torch.ones((B, 2), dtype=torch.bool)
    honest = sweep_step.plain_fused_signed_sweep_step(seed, st.order, st.leader, st.faulty,
                                                      st.alive, ok, m, R)
    assert calls == []
    assert (honest == ATTACK).all()
    fst = convert.state_from_numpy(_faulty_leaders(state), "cpu")
    sweep_step.plain_fused_signed_sweep_step(seed, fst.order, fst.leader, fst.faulty,
                                             fst.alive, ok, m, R)
    assert [(c[0], c[2], c[3]) for c in calls] == [(rr, 0, 0) for rr in range(R)]
