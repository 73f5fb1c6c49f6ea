"""K2's sharded form, ``fused_sharded_sweep_step`` (the port's counterpart of
``ba_tpu/ops/sweep_step.py:299``), through its plain version on the CPU:
one call a "data" shard, each numbering its instances from ``index_base
= shard * B / d``, so every shard count is bit-equal to the unsharded
step and no (seed, b) pair is drawn by two shards.  On a mesh, the
reference's K2 contract against the JAX package's XLA composition
(``tests/test_ops.py``'s ``_xla_sweep_step``, as
``tests/test_torch_sweep_step.py`` holds the unsharded step): bit-exact
with no traitors, equal in decision histograms with faulty leaders
(bands of 6 sqrt(B) a bin).  Inputs from numpy seeds; tolerance zero for
every exact comparison."""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core import sm_agreement
from ba_tpu.core.om import round1_broadcast
from ba_tpu.crypto.signed import sig_valid_from_tables
from ba_tpu.parallel import make_sweep_state
from ba_tpu_torch import convert
from ba_tpu_torch.ops import sweep_step
from ba_tpu_torch.parallel import make_mesh

CPU = torch.device("cpu")


def _xla_sweep_step(key, state, ok, m):
    """The composition the kernel fuses (bench.py's one_bucket)."""
    k1, k2 = jr.split(key)
    received = round1_broadcast(k1, state)
    sig_valid = sig_valid_from_tables(ok, received)
    return np.asarray(sm_agreement(k2, state, m, None, sig_valid, received, True)["decision"])


def _inputs(seed, B, n):
    rs = np.random.default_rng(seed)
    faulty = rs.random((B, n)) < 0.3
    faulty[::3, 0] = True  # faulty leaders: round-1 coins and relay draws decide
    alive = rs.random((B, n)) < 0.85
    for b in range(1, B, 4):  # few alive: a faulty leader and one traitor among 4-6
        alive[b] = False
        alive[b, :int(rs.integers(4, 7))] = True
        faulty[b, :2] = True
    tensors = dict(order=rs.integers(0, 2, B).astype(np.int8),
                   leader=np.where(rs.random(B) < 0.5, 0, rs.integers(0, 4, B)).astype(np.int32),
                   faulty=faulty, alive=alive, ok=rs.random((B, 2)) < 0.9)
    return {k: torch.as_tensor(v) for k, v in tensors.items()}


def _args(t):
    return t["order"], t["leader"], t["faulty"], t["alive"], t["ok"]


def _step(mesh, seed, state, ok, m, rounds=1):
    return np.asarray(sweep_step.fused_sharded_sweep_step(
        mesh, torch.tensor([seed], dtype=torch.int32), state.order, state.leader,
        state.faulty, state.alive, ok, m, rounds))


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("m,rounds", [(1, 1), (3, 5)])
def test_sharded_plain_is_the_unsharded_step(d, m, rounds):
    B, n = 32, 12
    t = _inputs(d + 10 * m, B, n)
    seed = torch.tensor([-7 + d], dtype=torch.int32)
    want = sweep_step.fused_signed_sweep_step(seed, *_args(t), m, rounds)
    got = sweep_step.fused_sharded_sweep_step(make_mesh((d, 1), devices=[CPU] * d), seed,
                                              *_args(t), m, rounds)
    assert got.shape == tuple(want.shape) and tuple(got.spec)[0] == "data"
    assert np.array_equal(np.asarray(got), want.numpy())
    # each shard's piece is the plain version on its rows from its index base
    per = B // d
    for k in range(d):
        rows = slice(k * per, (k + 1) * per)
        piece = sweep_step.plain_fused_signed_sweep_step(
            seed, *(x[rows] for x in _args(t)), m, rounds, index_base=k * per)
        assert torch.equal(piece, want[rows])


def test_index_base_keys_the_global_instance():
    """A shard drawing from base 0 would replay shard 0's streams: the
    draw-dependent rows of a slice differ between its own base and 0."""
    B, n, m = 64, 8, 3
    t = _inputs(3, B, n)
    seed = torch.tensor([11], dtype=torch.int32)
    whole = sweep_step.fused_signed_sweep_step(seed, *_args(t), m, 8)
    rows = slice(32, 64)
    mine = sweep_step.plain_fused_signed_sweep_step(seed, *(x[rows] for x in _args(t)), m, 8,
                                                    index_base=32)
    zero = sweep_step.plain_fused_signed_sweep_step(seed, *(x[rows] for x in _args(t)), m, 8)
    assert torch.equal(mine, whole[rows])
    assert not torch.equal(zero, whole[rows])
    with pytest.raises(ValueError, match="index_base"):
        sweep_step.plain_fused_signed_sweep_step(seed, *_args(t), m, 1, index_base=-1)
    with pytest.raises(ValueError, match="does not split"):
        sweep_step.fused_sharded_sweep_step(make_mesh((3, 1), devices=[CPU] * 3), seed,
                                            *_args(t), m)


@pytest.mark.parametrize("d", [1, 4])
def test_sharded_no_traitors_bit_exact_with_xla(d):
    B, cap, m = 64, 128, 3
    state = make_sweep_state(jr.key(0), B, cap, max_traitor_frac=0.0)
    ok = jnp.ones((B, 2), bool)
    want = _xla_sweep_step(jr.key(1), state, ok, m)
    st = convert.state_from_numpy(state, "cpu")
    mesh = make_mesh((d, 1), devices=[CPU] * d)
    got = _step(mesh, 3, st, torch.ones((B, 2), dtype=torch.bool), m, 4)
    for r in range(4):
        np.testing.assert_array_equal(got[:, r], want)


def test_sharded_faulty_leader_histograms_match_xla():
    B, cap, m = 8192, 16, 2
    state = make_sweep_state(jr.key(8), B, cap)
    faulty = np.array(state.faulty)
    faulty[:, 0] = True  # every leader equivocates
    state = type(state)(state.order, state.leader, jnp.asarray(faulty), state.alive, state.ids)
    ok = jnp.ones((B, 2), bool)
    h_want = np.bincount(_xla_sweep_step(jr.key(9), state, ok, m), minlength=3)
    st = convert.state_from_numpy(state, "cpu")
    got = _step(make_mesh((4, 1), devices=[CPU] * 4), 10, st,
                torch.ones((B, 2), dtype=torch.bool), m, 2)
    band = 6 * np.sqrt(B)
    assert len(np.unique(got)) > 1  # equivocation is visible
    for r in range(2):
        h_got = np.bincount(got[:, r], minlength=3)
        assert (np.abs(h_want - h_got) < band).all(), (r, h_want, h_got)
