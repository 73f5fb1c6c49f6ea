"""The benchmark's frozen reference and input draws against the port on
the CPU: the same bits where the port defines them."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ba_tpu_torch.core import rng
from ba_tpu_torch.crypto import oracle
from ba_tpu_torch.ops import sweep_step
from ba_tpu_torch.parallel import sweep
from portbench.inputs import draws, sweep_state
from portbench.reference import ed25519, om1, sm3
from portbench.reference import threefry as tf


def test_threefry_matches_the_port():
    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    assert torch.equal(tf.fold_in(key, 7), rng.fold_in(key, 7))
    assert torch.equal(tf.split(key, 3), rng.split(key, 3))
    assert torch.equal(tf.bits(key, (5, 7)), rng.bits(key, (5, 7)))
    assert torch.equal(tf.coin_bits(key, (33, 17)), rng.coin_bits(key, (33, 17)))
    assert torch.equal(tf.randint(key, (64,), 16, 1025), rng.randint(key, (64,), 16, 1025))
    assert torch.equal(tf.uniform(key, (9, 4)), rng.uniform(key, (9, 4)))
    assert tf.threefry_py((0x12345678, 0x9ABCDEF0), 7) == tuple(int(x) for x in tf.fold_in(key, 7))


def test_states_are_the_ports_draws_with_the_commander_among_the_traitors():
    """n and the traitor count are the port's draws under the same key;
    the traitors sit on alive generals, the commander among them about
    t/n of the time; buckets as the port's."""
    key = torch.tensor([3, 4], dtype=torch.int64)
    ours = sweep_state.sweep_state(key, 2000, 64, min_n=16, max_n=64)
    port = sweep.make_sweep_state(key, 2000, 64, min_n=16, max_n=64)
    assert torch.equal(ours["alive"], port.alive)
    assert torch.equal(ours["faulty"].sum(1), port.faulty.sum(1))
    assert not (ours["faulty"] & ~ours["alive"]).any()
    assert not port.faulty[:, 0].any()
    n, t = ours["alive"].sum(1), ours["faulty"].sum(1)
    assert (t <= n // 3).all()
    share = ours["faulty"][:, 0].float().mean()
    assert abs(share - (t / n).float().mean()) < 0.03
    buckets = sweep_state.bucketed_states(key, 30, 256, 2, min_n=4)
    port_b = sweep.bucketed_sweep_states(key, 30, 256, 2, min_n=4)
    assert [st["faulty"].shape for st in buckets] == [(15, 128), (15, 256)]
    assert all(torch.equal(a["alive"], b.alive) for a, b in zip(buckets, port_b))


def test_every_run_serves_the_same_deployment():
    from portbench.drivers.pipeline_sweep import state_of
    from portbench.tests.tiny import tiny_cell

    cfg = tiny_cell("om1_sweep.plain")["config"]
    a, b = state_of(cfg, "cpu"), state_of(cfg, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["faulty"][:, 0].any()


def test_samples_are_spread_and_drawn_without_repeats():
    gen = torch.Generator().manual_seed(3)
    rows = sweep_state.spread_rows(100, 10, gen)
    assert torch.equal(rows // 10, torch.arange(10))
    picked = sweep_state.pick(torch.arange(5, 50), 20, gen)
    assert len(set(picked.tolist())) == 20 and picked.min() >= 5


def test_om1_round_matches_the_port():
    key = torch.tensor([11, 12], dtype=torch.int64)
    st = sweep_state.sweep_state(key, 64, 48, min_n=16, max_n=48)
    keys = om1.round_keys(key, 5, torch.arange(64))
    state = sweep.SimState(**st)
    port = sweep.agreement_step(keys, state)
    ours = om1.round_outputs(keys, st)
    assert torch.equal(ours["decision"], port["decision"])
    # IC2: a loyal commander's instances decide its order
    traitorous = st["faulty"][:, 0]
    assert traitorous.any() and (ours["decision"][~traitorous] == om1.ATTACK).all()
    many = om1.campaign_decisions(key, 3, st, torch.arange(64))
    assert torch.equal(many[2], om1.round_outputs(om1.round_keys(key, 2, torch.arange(64)),
                                                  st)["decision"])


def test_sm3_matches_the_plain_k2():
    key = torch.tensor([21, 22], dtype=torch.int64)
    st = sweep_state.sweep_state(key, 32, 32, min_n=4, max_n=12)
    ok = torch.rand(32, 2, generator=torch.Generator().manual_seed(1)) > 0.3
    seed = torch.tensor([-12345], dtype=torch.int32)
    want = sweep_step.plain_fused_signed_sweep_step(seed, st["order"], st["leader"], st["faulty"],
                                                    st["alive"], ok, 3, 20)
    got = sm3.decisions(-12345, st, ok, torch.arange(32), 3, 20)
    assert torch.equal(got, want)
    # IC2 where the loyal commander's signatures verify
    loyal = ~st["faulty"][:, 0]
    got = sm3.decisions(-12345, st, torch.ones(32, 2, dtype=torch.bool), torch.arange(32), 3, 20)
    assert loyal.any() and (~loyal).any() and (got[loyal] == sm3.ATTACK).all()


def test_ed25519_matches_the_oracle():
    sk = ed25519.secret_key(77, 3)
    assert sk == oracle.secret_from_seed(b"77:3")
    pk = ed25519.publickey(sk)
    msg = ed25519.order_message(3, 1)
    sig = ed25519.sign(sk, pk, msg)
    assert pk == oracle.publickey(sk) and sig == oracle.sign(sk, pk, msg)
    assert ed25519.verify(pk, msg, sig)
    assert not ed25519.verify(pk, msg, bytes([sig[0] ^ 0xFF]) + sig[1:])


def test_step_seeds_on_the_device_match_the_host():
    keys = draws.campaign_keys(9, 3, "cpu")
    seeds = draws.step_seeds(draws.step_seed_mix(9, "cpu"), keys[2], 4, 2)
    for s in range(4):
        for b in range(2):
            want = draws.step_seed_py(9, tuple(int(x) for x in keys[2]), s, b, 2)
            assert int(seeds[s, b]) & 0xFFFFFFFF == want


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_draws_repeat_and_use_every_seed_bit(seed):
    a = draws.campaign_keys(seed, 4, "cpu")
    assert torch.equal(a, draws.campaign_keys(seed, 4, "cpu"))
    assert not torch.equal(a, draws.campaign_keys(seed + 2**32, 4, "cpu"))
    planes = draws.kill_planes(seed, 2, 3, 5, 8, 0.5, 1, "cpu")
    again = draws.kill_planes(seed, 2, 3, 5, 8, 0.5, 1, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(planes, again))
    assert planes[0][1, :, 0].all()
    assert np.isin([draws.spoiled_value(seed, i) for i in range(8)], [0, 1]).all()
