"""The port's coalesced serving batch (``coalesced_megastep``,
``coalesced_sweep``) against ``ba_tpu``'s XLA engine, on the CPU.

Every slot of a coalesced batch is an independent request: one base key
a slot, every slot folding instance index 0, one counter block a slot.
The port must be bit-identical to the reference's ``engine="xla"``, and
each slot to its own B = 1 run.  Inputs come from numpy seeds and reach
both packages through ``ba_tpu_torch.convert``.  Tolerance is zero
everywhere: every output, every column of the last round's majorities
(dead and padded generals included), the counters, the leaders, the
advanced counter and the in-place carry.
"""

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

CAP = 4  # the serving tests' padded capacity


def _arrays(seed, B, n, R):
    """A random cohort: random leaders (row 1's leader dead), dead
    generals, an all-dead row 0, random strategies (lie-table ones among
    them) and random kill / revive / fault / strategy events."""
    rs = np.random.default_rng(seed)
    state = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=rs.integers(0, n, B).astype(np.int32),
        faulty=rs.random((B, n)) < 0.35,
        alive=rs.random((B, n)) < 0.8,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    state["alive"][0] = False
    if B > 1:
        state["alive"][1, state["leader"][1]] = False
    kill = rs.random((R, B, n)) < 0.1
    events = dict(
        kill=kill,
        revive=(rs.random((R, B, n)) < 0.1) & ~kill,
        set_faulty=np.where(rs.random((R, B, n)) < 0.2,
                            rs.integers(0, 2, (R, B, n)), -1).astype(np.int8),
        set_strategy=np.where(rs.random((R, B, n)) < 0.3,
                              rs.integers(0, 6, (R, B, n)), -1).astype(np.int8),
    )
    strategy = rs.integers(0, 6, (B, n)).astype(np.int8)
    strategy[:, 1] = 4  # a lie-table strategy (adaptive split) on every general 1
    state["faulty"][:, 1] = True
    return state, events, strategy


def _jstate(arrays):
    return JState(**{k: jnp.asarray(v).copy() for k, v in arrays.items()})


def _tstate(arrays):
    return convert.state_from_numpy(type("S", (), arrays), "cpu")


def _eq(jax_value, torch_value, what=""):
    if isinstance(torch_value, torch.Tensor):
        torch_value = torch_value.numpy()
    assert np.array_equal(np.asarray(jax_value), torch_value), what


def _seeds(B, seed):
    return [seed * 100 + b for b in range(B)]


@pytest.mark.parametrize("scenario", [False, True])
@pytest.mark.parametrize("seed,B,n,R", [(0, 5, 4, 6), (1, 8, 16, 3), (2, 3, 33, 8)])
def test_coalesced_megastep_matches_xla(seed, B, n, R, scenario):
    arrays, events, strategy = _arrays(seed, B, n, R)
    C = 5 if scenario else 3
    block = np.random.default_rng(seed).integers(0, 9, (B, C)).astype(np.int32)
    seeds, counter = _seeds(B, seed), 7 + seed
    j_out = jp.coalesced_megastep(
        _jstate(arrays), jp.make_slot_key_schedule([jr.key(s) for s in seeds], counter),
        jnp.asarray(strategy) if scenario else None, jnp.asarray(block),
        {k: jnp.asarray(v) for k, v in events.items()} if scenario else None,
        rounds=R, scenario=scenario,
    )
    key_data = np.stack([np.asarray(jr.key_data(jr.key(s))) for s in seeds])
    tstate = _tstate(arrays)
    sched = convert.slot_schedule_from_numpy(key_data, counter, "cpu")
    t_strategy = convert.strategy_from_numpy(strategy, "cpu") if scenario else None
    t_out = tp.coalesced_megastep(
        tstate, sched, t_strategy, convert.slot_counters_from_numpy(block, "cpu"),
        convert.events_from_numpy(events, "cpu") if scenario else None,
        rounds=R, scenario=scenario,
    )
    assert len(t_out) == len(j_out) == (7 if scenario else 6)
    # the carry is updated in place and handed back
    assert t_out[0] is tstate and t_out[1] is sched and t_out[2] is t_strategy  # ba-lint: disable=BA201 (the in-place contract)
    for name, value in convert.state_to_numpy(t_out[0]).items():
        _eq(getattr(j_out[0], name), value, name)
    _eq(j_out[1].key_data, t_out[1].key_data.numpy().astype(np.uint32), "key data")
    assert int(j_out[1].counter) == int(t_out[1].counter) == counter + R
    if scenario:
        _eq(j_out[2], t_out[2], "strategy")
    assert t_out[3].shape == (B, n)
    for name, a, b in zip(("majorities", "decisions", "counter_rows", "leaders"),
                          j_out[3:], t_out[3:]):
        _eq(a, b, name)
    assert not arrays["alive"][0].any()  # the all-dead row's majorities were compared too


def _request_state(reqs):
    """The cohort's padded [B, CAP] state: request i at slot i, alive =
    its first n generals, leader 0."""
    B = len(reqs)
    faulty = np.zeros((B, CAP), bool)
    alive = np.zeros((B, CAP), bool)
    for i, (_, n, fl, _) in enumerate(reqs):
        alive[i, :n] = True
        faulty[i, list(fl)] = True
    return dict(order=np.array([o for o, *_ in reqs], np.int8),
                leader=np.zeros(B, np.int32), faulty=faulty, alive=alive,
                ids=np.tile(np.arange(1, CAP + 1, dtype=np.int32), (B, 1)))


# (order, n, faulty, seed): tests/test_serve.py's three plain requests
PLAIN_REQS = [(1, 4, (2,), 11), (0, 3, (), 12), (1, 4, (1, 3), 13)]


def _scenario_cohort():
    """tests/test_serve.py's two scenario requests, their B = 1 blocks
    and their planes side by side."""
    specs = [
        {"name": "a", "rounds": 4, "events": [{"round": 1, "kill": [1]}]},
        {"name": "b", "rounds": 4, "events": [
            {"round": 2, "set_faulty": [2], "value": True},
            {"round": 3, "set_strategy": [2], "value": "collude_attack"}]},
    ]
    ids = np.arange(1, CAP + 1, dtype=np.int64)
    blocks = [j_compile.compile_scenario(j_spec.from_dict(s), 1, CAP, ids=ids) for s in specs]
    planes = {name: np.concatenate([getattr(b, name) for b in blocks], axis=1)
              for name in t_compile.PLANE_NAMES}
    return [(1, 4, (), 21), (1, 4, (3,), 22)], blocks, planes


def _keys(reqs, device="cpu"):
    return [rng.key(seed, device=device) for *_, seed in reqs]


def test_coalesced_sweep_plain_matches_xla():
    arrays = _request_state(PLAIN_REQS)
    windows = []
    j_out = jp.coalesced_sweep([jr.key(s) for *_, s in PLAIN_REQS], _jstate(arrays), 4,
                               rounds_per_dispatch=2, engine="xla")
    t_out = tp.coalesced_sweep(_keys(PLAIN_REQS), _tstate(arrays), 4, rounds_per_dispatch=2,
                               device="cpu",
                               on_retire=lambda d, lo, hi, ys: windows.append((lo, hi)))
    assert windows == [(0, 2), (2, 4)]
    for name in ("decisions", "majorities", "counters"):
        _eq(j_out[name], t_out[name], name)
    assert t_out["counter_names"] == j_out["counter_names"] == list(tp.COUNTER_NAMES)
    for name in ("dispatches", "depth", "slots", "max_in_flight"):
        assert t_out["stats"][name] == j_out["stats"][name], name
    assert t_out["stats"]["engine"] == "torch" and "leaders" not in t_out


def test_coalesced_sweep_scenario_matches_xla():
    reqs, _, planes = _scenario_cohort()
    arrays = _request_state(reqs)
    j_out = jp.coalesced_sweep([jr.key(s) for *_, s in reqs], _jstate(arrays), 4,
                               rounds_per_dispatch=2, scenario=planes, engine="xla")
    windows = []
    t_out = tp.coalesced_sweep(_keys(reqs), _tstate(arrays), 4, rounds_per_dispatch=2,
                               scenario=planes, device="cpu",
                               on_retire=lambda d, lo, hi, ys: windows.append((lo, hi)))
    assert windows == [(0, 2), (2, 4)]
    for name in ("decisions", "majorities", "counters", "leaders"):
        _eq(j_out[name], t_out[name], name)
    assert t_out["counter_names"] == list(tp.SCENARIO_COUNTER_NAMES)
    # a ScenarioBlock of the same planes runs the same batch
    block = t_compile.ScenarioBlock(**planes)
    again = tp.coalesced_sweep(_keys(reqs), _tstate(arrays), 4, rounds_per_dispatch=2,
                               scenario=block, device="cpu")
    for name in ("decisions", "majorities", "counters", "leaders"):
        assert np.array_equal(again[name], t_out[name]), name


def _slot(arrays, i):
    return {k: v[i:i + 1] for k, v in arrays.items()}


def test_each_slot_equals_its_own_run_alone_plain():
    reqs = PLAIN_REQS + [(0, 4, (0,), 14), (1, 2, (), 15)]  # a faulty leader, n = 2
    arrays = _request_state(reqs)
    co = tp.coalesced_sweep(_keys(reqs), _tstate(arrays), 5, rounds_per_dispatch=2,
                            device="cpu")
    for i, (*_, seed) in enumerate(reqs):
        solo = tp.coalesced_sweep([rng.key(seed, device="cpu")], _tstate(_slot(arrays, i)), 5,
                                  rounds_per_dispatch=2, device="cpu")
        for name in ("decisions", "counters"):
            assert np.array_equal(co[name][..., i:i + 1] if name == "decisions"
                                  else co[name][i:i + 1], solo[name]), (i, name)
        assert np.array_equal(co["majorities"][i], solo["majorities"][0]), i
        alone = tp.pipeline_sweep(rng.key(seed, device="cpu"), _tstate(_slot(arrays, i)), 5,
                                  rounds_per_dispatch=2, collect_decisions=True,
                                  with_counters=True, device="cpu")
        assert np.array_equal(co["decisions"][:, i], alone["decisions"][:, 0]), i
        assert dict(zip(co["counter_names"], co["counters"][i].tolist())) \
            == alone["counters"], i


def test_each_slot_equals_its_own_run_alone_scenario():
    reqs, blocks, planes = _scenario_cohort()
    arrays = _request_state(reqs)
    co = tp.coalesced_sweep(_keys(reqs), _tstate(arrays), 4, rounds_per_dispatch=3,
                            scenario=planes, device="cpu")
    for i, ((*_, seed), block) in enumerate(zip(reqs, blocks)):
        t_block = convert.block_from_numpy(block)
        solo = tp.coalesced_sweep([rng.key(seed, device="cpu")], _tstate(_slot(arrays, i)), 4,
                                  rounds_per_dispatch=3, scenario=t_block, device="cpu")
        assert np.array_equal(co["majorities"][i], solo["majorities"][0]), i
        assert np.array_equal(co["counters"][i], solo["counters"][0]), i
        alone = tp.scenario_sweep(rng.key(seed, device="cpu"), _tstate(_slot(arrays, i)),
                                  t_block, rounds_per_dispatch=2, collect_decisions=True,
                                  device="cpu")
        for name in ("decisions", "leaders"):
            assert np.array_equal(co[name][:, i], alone[name][:, 0]), (i, name)
        assert dict(zip(co["counter_names"], co["counters"][i].tolist())) \
            == alone["counters"], i


def test_exec_seam_sees_every_dispatch_and_retire():
    arrays = _request_state(PLAIN_REQS)
    seen = []

    def seam(call, phase, d, lo, hi):
        seen.append((phase, d, lo, hi))
        return call()

    out = tp.coalesced_sweep(_keys(PLAIN_REQS), _tstate(arrays), 5, rounds_per_dispatch=2,
                             depth=1, exec_seam=seam, device="cpu")
    assert seen == [("dispatch", 0, 0, 2), ("dispatch", 1, 2, 4), ("retire", 0, 0, 2),
                    ("dispatch", 2, 4, 5), ("retire", 1, 2, 4), ("retire", 2, 4, 5)]
    assert out["stats"]["dispatches"] == 3 and out["stats"]["max_in_flight"] == 2


def test_cuda_coalesced_megastep_runs_the_plain_version_on_cpu_tensors():
    arrays, events, strategy = _arrays(3, 4, 6, 3)
    before = scenario_step.cuda_coalesced_megastep.launches
    outs = []
    for fn in (tp.coalesced_megastep, scenario_step.cuda_coalesced_megastep):
        sched = convert.slot_schedule_from_numpy([[0, 9], [0, 10], [1, 2], [3, 4]], 2, "cpu")
        outs.append(fn(
            _tstate(arrays), sched, convert.strategy_from_numpy(strategy, "cpu"),
            torch.zeros((4, 5), dtype=torch.int32), convert.events_from_numpy(events, "cpu"),
            rounds=3, scenario=True,
        ))
    assert len(outs[0]) == len(outs[1]) == 7
    for a, b in zip(outs[0][2:], outs[1][2:]):
        assert torch.equal(a, b)
    assert int(outs[1][1].counter) == 5
    assert scenario_step.cuda_coalesced_megastep.launches == before  # no kernel launched


def test_coalesced_validation():
    arrays = _request_state(PLAIN_REQS)
    keys = _keys(PLAIN_REQS)
    run = lambda *a, **kw: tp.coalesced_sweep(*a, device="cpu", **kw)  # noqa: E731
    with pytest.raises(ValueError, match="slot key"):
        run(keys[:2], _tstate(arrays), 4)
    _, _, planes = _scenario_cohort()
    with pytest.raises(ValueError, match="scenario planes"):
        run(keys, _tstate(arrays), 4, scenario=planes)
    with pytest.raises(ValueError, match="signed"):
        run(keys, _tstate(arrays), 4, signed=True, scenario=planes, pool=0)
    with pytest.raises(ValueError, match="signed"):
        run(keys, _tstate(arrays), 4, collapsed=True)
    with pytest.raises(ValueError, match="m=2"):  # K1 is OM(1) only; m = 2 runs on "torch"
        run(keys, _tstate(arrays), 4, m=2, engine="cuda")
    with pytest.raises(ValueError, match="initial_strategy"):
        run(keys, _tstate(arrays), 4, initial_strategy=np.zeros((3, CAP), np.int8))
    with pytest.raises(ValueError, match="ScenarioBlock"):
        run(keys, _tstate(arrays), 4, scenario={"kill": planes["kill"]})
    with pytest.raises(ValueError):
        run(keys, _tstate(arrays), 4, engine="cuda")
    with pytest.raises(ValueError):
        convert.slot_schedule_from_numpy([0, 9], 0, "cpu")
