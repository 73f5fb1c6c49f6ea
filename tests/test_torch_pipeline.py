"""The port's plain engine (``engine="torch"``) against ``ba_tpu``'s XLA
engine: megasteps on a fuzz of strategy mixes with kills, revives and
fault flips; the sweeps end to end with depth 2 and a remainder
dispatch; the committed coalition spec; the depth-k dispatch trace.
Inputs come from numpy seeds and reach both packages through
``ba_tpu_torch.convert``.  Tolerance is zero everywhere."""

import os

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core.state import SimState as JState
from ba_tpu.parallel import pipeline as jp
from ba_tpu.scenario import compile as j_compile
from ba_tpu.scenario import spec as j_spec
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.ops import scenario_step
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.scenario import compile as t_compile
from ba_tpu_torch.scenario import spec as t_spec

COALITION = os.path.join(
    os.path.dirname(__file__), "..", "examples", "scenarios", "colluding_coalition.json"
)


def _arrays(seed, B, n, R, faulty_leaders=True):
    rs = np.random.default_rng(seed)
    state = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=(rs.integers(0, n, B) if faulty_leaders else np.zeros(B)).astype(np.int32),
        faulty=rs.random((B, n)) < 0.35,
        alive=rs.random((B, n)) < 0.85,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    state["alive"][0] = False  # an all-dead row: elects index 0, decides UNDEFINED
    kill = rs.random((R, B, n)) < 0.1
    events = dict(
        kill=kill,
        revive=(rs.random((R, B, n)) < 0.1) & ~kill,
        set_faulty=np.where(rs.random((R, B, n)) < 0.2,
                            rs.integers(0, 2, (R, B, n)), -1).astype(np.int8),
        set_strategy=np.where(rs.random((R, B, n)) < 0.3,
                              rs.integers(0, 5, (R, B, n)), -1).astype(np.int8),
    )
    strategy = rs.integers(0, 5, (B, n)).astype(np.int8)
    return state, events, strategy


def _jstate(arrays):
    return JState(**{k: jnp.asarray(v).copy() for k, v in arrays.items()})


def _tstate(arrays):
    return convert.state_from_numpy(type("S", (), arrays), "cpu")


def _eq(jax_value, torch_value):
    if isinstance(torch_value, torch.Tensor):
        torch_value = torch_value.numpy()
    assert np.array_equal(np.asarray(jax_value), torch_value)


def _same_state(jstate, tstate):
    for name, value in convert.state_to_numpy(tstate).items():
        assert np.array_equal(np.asarray(getattr(jstate, name)), value), name


@pytest.mark.parametrize("seed,B,n,R", [(0, 4, 5, 6), (1, 8, 9, 7), (2, 3, 33, 5),
                                        (3, 9, 16, 9), (4, 16, 1, 4)])
def test_scenario_megastep_matches_xla(seed, B, n, R):
    arrays, events, strategy = _arrays(seed, B, n, R)
    counter = 5 + seed
    j_out = jp.scenario_megastep(
        _jstate(arrays), jp.make_key_schedule(jr.key(seed), counter),
        jnp.asarray(strategy), jp.scenario_counters_init(),
        {k: jnp.asarray(v) for k, v in events.items()},
        rounds=R, collect_decisions=True,
    )
    tstate = _tstate(arrays)
    sched = convert.schedule_from_numpy(np.asarray(jr.key_data(jr.key(seed))), counter, "cpu")
    t_out = tp.scenario_megastep(
        tstate, sched, convert.strategy_from_numpy(strategy, "cpu"),
        tp.scenario_counters_init("cpu"), convert.events_from_numpy(events, "cpu"),
        rounds=R, collect_decisions=True,
    )
    # the carry is reused in place
    assert t_out[0] is tstate and t_out[1] is sched  # ba-lint: disable=BA201 (the in-place contract)
    _same_state(j_out[0], t_out[0])
    key_data, ctr = convert.schedule_to_numpy(t_out[1])
    _eq(j_out[1].key_data, key_data)
    assert int(j_out[1].counter) == ctr == counter + R
    _eq(j_out[2], t_out[2])  # strategy plane
    for name, a, b in zip(("histograms", "leaders", "counter_rows", "decisions"),
                          j_out[3:], t_out[3:]):
        _eq(a, b)


@pytest.mark.parametrize("with_counters", [False, True])
@pytest.mark.parametrize("seed,B,n,R", [(5, 6, 7, 5), (6, 12, 16, 3)])
def test_pipeline_megastep_matches_xla(seed, B, n, R, with_counters):
    arrays, _, _ = _arrays(seed, B, n, R)
    counters = np.array([3, 1, 2], np.int32) if with_counters else None
    j_out = jp.pipeline_megastep(
        _jstate(arrays), jp.make_key_schedule(jr.key(seed), 2), rounds=R,
        collect_decisions=True,
        counters=None if counters is None else jnp.asarray(counters),
    )
    t_out = tp.pipeline_megastep(
        _tstate(arrays),
        convert.schedule_from_numpy(np.asarray(jr.key_data(jr.key(seed))), 2, "cpu"),
        rounds=R, collect_decisions=True,
        counters=None if counters is None else convert.counters_from_numpy(counters, "cpu"),
    )
    assert len(j_out) == len(t_out)
    _same_state(j_out[0], t_out[0])
    assert int(j_out[1].counter) == int(t_out[1].counter)
    for a, b in zip(j_out[2:], t_out[2:]):
        _eq(a, b)


def test_pipeline_sweep_matches_xla():
    B, n, R = 10, 12, 7
    arrays, _, _ = _arrays(7, B, n, R)
    kw = dict(depth=2, rounds_per_dispatch=3, collect_decisions=True, with_counters=True)
    j_out = jp.pipeline_sweep(jr.key(21), _jstate(arrays), R, engine="xla", **kw)
    t_out = tp.pipeline_sweep(rng.key(21, device="cpu"), _tstate(arrays), R,
                              device="cpu", **kw)
    assert set(t_out) == {k for k in j_out if k != "stats"} | {"stats"}
    for name in ("histograms", "decisions", "counters_per_round", "final_counters"):
        _eq(j_out[name], t_out[name])
    assert j_out["counters"] == t_out["counters"]
    _same_state(j_out["final_state"], t_out["final_state"])
    assert int(j_out["final_schedule"].counter) == int(t_out["final_schedule"].counter) == R
    for name in ("dispatches", "depth", "rounds_per_dispatch", "max_in_flight"):
        assert j_out["stats"][name] == t_out["stats"][name], name
    assert t_out["stats"]["engine"] == "torch"


@pytest.mark.parametrize("sparse", [False, True])
def test_scenario_sweep_matches_xla(sparse):
    B, n, R = 9, 11, 8
    arrays, events, strategy = _arrays(8, B, n, R)
    j_block = j_compile.ScenarioBlock(**events)
    if sparse:  # a sparse block from a spec, with kills and fault flips
        doc = {"name": "mixed", "rounds": R, "order": "attack", "events": [
            {"round": 1, "kill": [1]}, {"round": 2, "set_faulty": [3, 4], "value": True},
            {"round": 3, "set_strategy": [3], "value": "adaptive_split"},
            {"round": 5, "revive": [1], "instances": [0, 2]},
            {"round": 6, "set_strategy": [4], "value": "silent"}]}
        j_block = j_compile.compile_scenario(j_spec.from_dict(doc), B, n, sparse=True)
    kw = dict(depth=2, rounds_per_dispatch=3, collect_decisions=True)
    j_out = jp.scenario_sweep(jr.key(31), _jstate(arrays), j_block, engine="xla",
                              initial_strategy=jnp.asarray(strategy), **kw)
    t_out = tp.scenario_sweep(rng.key(31, device="cpu"), _tstate(arrays),
                              convert.block_from_numpy(j_block), device="cpu",
                              initial_strategy=torch.tensor(strategy), **kw)
    for name in ("histograms", "decisions", "leaders", "counters_per_round", "final_counters"):
        _eq(j_out[name], t_out[name])
    assert j_out["counters"] == t_out["counters"]
    _same_state(j_out["final_state"], t_out["final_state"])
    _eq(j_out["final_strategy"], t_out["final_strategy"])
    assert int(j_out["final_schedule"].counter) == int(t_out["final_schedule"].counter)


def test_colluding_coalition_spec_matches_xla():
    B, n = 6, 8
    j_block = j_compile.compile_scenario(j_spec.load(COALITION), B, n)
    t_block = t_compile.compile_scenario(t_spec.load(COALITION), B, n)
    for name in t_compile.PLANE_NAMES:
        assert np.array_equal(getattr(j_block, name), getattr(t_block, name))
    arrays, _, _ = _arrays(9, B, n, 1, faulty_leaders=False)
    arrays["order"][:] = 0  # the spec's order: retreat
    kw = dict(depth=2, rounds_per_dispatch=3, collect_decisions=True)
    j_out = jp.scenario_sweep(jr.key(5), _jstate(arrays), j_block, engine="xla", **kw)
    t_out = tp.scenario_sweep(rng.key(5, device="cpu"), _tstate(arrays), t_block,
                              device="cpu", **kw)
    for name in ("histograms", "decisions", "leaders", "counters_per_round"):
        _eq(j_out[name], t_out[name])
    assert t_out["counters"]["ic1_violations"] > 0  # the coalition does break IC1


def test_depth_k_dispatch_trace():
    arrays, _, _ = _arrays(10, 4, 5, 1)
    trace, work = [], []
    out = tp.pipeline_sweep(
        rng.key(0, device="cpu"), _tstate(arrays), 10, depth=2, rounds_per_dispatch=2,
        on_event=lambda kind, d: trace.append((kind, d)), host_work=work.append,
        device="cpu",
    )
    assert trace == [("dispatch", 0), ("dispatch", 1), ("dispatch", 2), ("retire", 0),
                     ("dispatch", 3), ("retire", 1), ("dispatch", 4), ("retire", 2),
                     ("retire", 3), ("retire", 4)]
    assert work == [0, 1, 2, 3, 4]
    assert out["stats"]["max_in_flight"] == 3
    assert out["stats"]["retires_before_drain"] == 3


def test_carry_is_reused_in_place_and_fresh_copy_keeps_it():
    arrays, events, strategy = _arrays(11, 5, 6, 4)
    state = _tstate(arrays)
    kept = tp.fresh_copy(state)
    out = tp.scenario_sweep(rng.key(1, device="cpu"), state,
                            t_compile.ScenarioBlock(**events), device="cpu")
    # the run consumed the input: the in-place contract this test pins
    assert out["final_state"].alive is state.alive  # ba-lint: disable=BA201 (the contract)
    assert not torch.equal(kept.alive, state.alive)  # ba-lint: disable=BA201 (the contract)
    for name, value in convert.state_to_numpy(kept).items():
        assert np.array_equal(arrays[name], value), name


def test_sweep_validation():
    arrays, _, _ = _arrays(12, 3, 4, 2)
    # m = 2 runs on the composed engine; K1 is OM(1) only, so engine="cuda" raises
    assert tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), 2, m=2,
                             device="cpu")["stats"]["engine"] == "torch"
    with pytest.raises(ValueError, match="m=2"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), 2, m=2, device="cpu",
                          engine="cuda")
    with pytest.raises(ValueError):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), 2, depth=0, device="cpu")
    with pytest.raises(ValueError):
        tp.scenario_sweep(rng.key(0, device="cpu"), _tstate(arrays),
                          t_compile.empty_block(2, 3, 5), device="cpu")
    with pytest.raises(ValueError):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), 2, device="cpu",
                          engine="xla")


def test_cuda_wrappers_run_the_plain_version_on_cpu_tensors():
    arrays, events, strategy = _arrays(13, 4, 6, 3)
    before = (scenario_step.cuda_pipeline_megastep.launches,
              scenario_step.cuda_scenario_megastep.launches)
    outs = []
    for fn in (tp.scenario_megastep, scenario_step.cuda_scenario_megastep):
        outs.append(fn(
            _tstate(arrays), convert.schedule_from_numpy([0, 9], 0, "cpu"),
            convert.strategy_from_numpy(strategy, "cpu"), tp.scenario_counters_init("cpu"),
            convert.events_from_numpy(events, "cpu"), rounds=3, collect_decisions=True,
        ))
    for a, b in zip(outs[0][3:], outs[1][3:]):
        assert torch.equal(a, b)
    plain = scenario_step.cuda_pipeline_megastep(
        _tstate(arrays), convert.schedule_from_numpy([0, 9], 0, "cpu"), rounds=2)
    assert plain[2].shape == (2, 3)
    after = (scenario_step.cuda_pipeline_megastep.launches,
             scenario_step.cuda_scenario_megastep.launches)
    assert after == before  # no kernel launched
