"""The legacy strategy chains (``ba_tpu_torch/scenario/strategies.py``:
``chain_impl``, ``lie_values_chain``, ``send_gate_chain``) against
``ba_tpu``'s, and a ``chain_impl()`` campaign against the branch-free one
and the reference's ``chain_impl()`` campaign on ``engine="xla"``.  Every
output is integer: bit-equal."""

import re
import subprocess

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.parallel import make_sweep_state as j_make_sweep_state
from ba_tpu.parallel import scenario_sweep as j_scenario_sweep
from ba_tpu.parallel.pipeline import scenario_megastep as j_scenario_megastep
from ba_tpu.parallel.sweep import agreement_step as j_agreement_step
from ba_tpu.scenario import strategies as j_strategies
from ba_tpu.scenario.compile import ScenarioBlock as JBlock
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.ops import _build
from ba_tpu_torch.parallel import pipeline, sweep
from ba_tpu_torch.scenario import strategies
from ba_tpu_torch.scenario.compile import ScenarioBlock


def _oral(seed):
    """The shape of ``tests/test_megastep.py:216``: [4, 1, 7] ids (some
    unknown), [4, 7, 7] coins, receivers along the middle axis."""
    rs = np.random.default_rng(seed)
    return (rs.integers(-3, 8, (4, 1, 7)).astype(np.int8),
            rs.integers(0, 2, (4, 7, 7)).astype(np.int8),
            np.arange(7, dtype=np.int32)[None, :, None],
            rs.integers(0, 2, (4, 7, 7, 2)).astype(bool))


@pytest.mark.parametrize("seed", [11, 12])
def test_chain_forms_bit_equal_reference(seed):
    strat, coins, ridx, gates = _oral(seed)
    vidx = np.arange(2)[None, None, None, :]
    want = np.asarray(j_strategies.lie_values_chain(
        jnp.asarray(strat), jnp.asarray(coins), jnp.asarray(ridx)))
    got = strategies.lie_values_chain(torch.tensor(strat), torch.tensor(coins),
                                      torch.tensor(ridx))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, strategies.lie_values(torch.tensor(strat), torch.tensor(coins),
                                                  torch.tensor(ridx)))
    args = (strat[..., None], gates, ridx[..., None], vidx)
    want = np.asarray(j_strategies.send_gate_chain(*map(jnp.asarray, args)))
    got = strategies.send_gate_chain(*map(torch.tensor, args))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert torch.equal(got, strategies.send_gate(*map(torch.tensor, args)))


def test_chain_impl_routes_the_two_entry_points():
    """Every int8 id: inside the context the entry points are the chains,
    outside the table; both give the same bits, and the flag is restored
    on the way out, also when the body raises."""
    strat = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)[:, None]
    coins = torch.tensor(np.random.default_rng(3).integers(0, 2, (256, 6)), dtype=torch.int8)
    ridx = torch.arange(6)[None]
    table = strategies.lie_values(strat, coins, ridx)
    with pytest.raises(RuntimeError):
        with strategies.chain_impl():
            assert strategies.chain_active()
            assert torch.equal(strategies.lie_values(strat, coins, ridx), table)
            raise RuntimeError
    assert not strategies.chain_active()
    with strategies.chain_impl(), strategies.chain_impl(False):
        assert not strategies.chain_active()


def test_per_instance_round_bit_equal_reference():
    """``agreement_step`` under ``chain_impl()`` (the per-instance round)
    against the reference's, traced afresh under its flag, with and
    without a strategy plane."""
    B, n = 6, 8
    state = j_make_sweep_state(jr.key(60), B, n)
    t_state = convert.state_from_numpy(state, "cpu")
    strat = np.random.default_rng(6).integers(0, 5, (B, n)).astype(np.int8)
    keys = jr.split(jr.key(61), B)
    t_keys = convert.key_from_numpy(np.asarray(jax.random.key_data(keys)), "cpu")
    for plane in (None, strat):
        with j_strategies.chain_impl():
            want = jax.jit(lambda k, st, s=plane: j_agreement_step(
                k, st, strategies=None if s is None else jnp.asarray(s)))(keys, state)
        t_plane = None if plane is None else torch.tensor(plane)
        with strategies.chain_impl():
            got = sweep.agreement_step(t_keys, t_state, strategies=t_plane)
        branch_free = sweep.agreement_step(t_keys, t_state, strategies=t_plane)
        for name in ("majorities", "decision", "needed", "total", "histogram"):
            assert np.array_equal(np.asarray(want[name]), got[name].numpy()), name
            assert torch.equal(got[name], branch_free[name]), name


def _campaign(B, n, R):
    """``bench_megastep_ab``'s campaign (``bench.py:3709``) at a small
    shape: every strategy id, 2 % kills, 1 % revives, 5 % strategy churn."""
    rs = np.random.default_rng(41)
    strat0 = rs.integers(0, 5, (B, n)).astype(np.int8)
    planes = dict(
        kill=rs.random((R, B, n)) < 0.02,
        revive=rs.random((R, B, n)) < 0.01,
        set_faulty=np.full((R, B, n), -1, np.int8),
        set_strategy=np.where(rs.random((R, B, n)) < 0.05,
                              rs.integers(0, 5, (R, B, n)), -1).astype(np.int8),
    )
    return strat0, planes


def test_chain_impl_campaign_bit_equal_branch_free_and_reference():
    B, n, R = 32, 16, 12
    strat0, planes = _campaign(B, n, R)
    kw = dict(depth=2, rounds_per_dispatch=4, collect_decisions=True)
    state = j_make_sweep_state(jr.key(40), B, n)
    t_states = [convert.state_from_numpy(state, "cpu") for _ in range(2)]  # jax consumes it
    j_scenario_megastep.clear_cache()
    try:
        with j_strategies.chain_impl():
            want = j_scenario_sweep(jr.key(42), state, JBlock(**planes),
                                    initial_strategy=jnp.asarray(strat0), engine="xla", **kw)
    finally:
        j_scenario_megastep.clear_cache()
    key = rng.key(42, device="cpu")
    outs = []
    for chain, t_state in zip((True, False), t_states):
        with strategies.chain_impl(chain):
            outs.append(pipeline.scenario_sweep(
                key, t_state, ScenarioBlock(**planes),
                initial_strategy=torch.tensor(strat0), engine="torch", device="cpu", **kw))
    for got in outs:
        for name in ("decisions", "leaders", "histograms", "counters_per_round"):
            assert np.array_equal(want[name], got[name]), name
        assert np.array_equal(np.asarray(want["final_strategy"]),
                              got["final_strategy"].numpy())
        for name, value in convert.state_to_numpy(got["final_state"]).items():
            assert np.array_equal(np.asarray(getattr(want["final_state"], name)), value), name


def test_k1_reads_the_lie_table_alone(tmp_path):
    """K1 has one formulation: ``lie_value`` in ``ops/csrc/megastep.cu``,
    compiled here for the host, answers every int8 id and both receiver
    parities as the table and the chain do: there is no second
    formulation for the flag to select."""
    src = (_build.CSRC / "megastep.cu").read_text()
    body = re.search(r"__device__ __forceinline__ int lie_value\(int s, int recv\) \{.*?\n\}\n",
                     src, re.S).group(0)
    prog = tmp_path / "lie.cpp"
    prog.write_text(
        "#include <cstdio>\n#define __device__\n#define __forceinline__ inline\n"
        "constexpr int RETREAT = 0, ATTACK = 1, UNDEFINED = 2;\n" + body
        + "int main() { for (int s = -128; s < 128; ++s) for (int r = 0; r < 2; ++r)"
          " std::printf(\"%d\\n\", lie_value(s, r)); }\n")
    exe = tmp_path / "lie"
    subprocess.run(["g++", "-O1", "-o", str(exe), str(prog)], check=True, timeout=120)
    kernel = np.array(subprocess.run([str(exe)], capture_output=True, text=True, check=True,
                                     timeout=60).stdout.split(), dtype=np.int64).reshape(256, 2)
    strat = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)[:, None]
    coin = torch.full((256, 2), -1, dtype=torch.int8)  # a coin reads -1, as in the kernel
    ridx = torch.arange(2)[None]
    assert np.array_equal(strategies.lie_values(strat, coin, ridx).numpy(), kernel)
    with strategies.chain_impl():
        assert np.array_equal(strategies.lie_values(strat, coin, ridx).numpy(), kernel)
