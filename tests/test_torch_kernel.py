"""The port's CUDA kernels against their plain versions on the card: K1
(``ba_tpu_torch/ops/csrc/megastep.cu``, plain, scenario and slot modes), K2 (``sweep_step.cu``), the
Ed25519 kernels K7, K5, K5', K6, K4, K8, K3, K3' and K3'' (``decompress.cu``,
``sha512_modl.cu``, ``modl.cu``, ``treeadd.cu``, ``powchain.cu``,
``window_verify.cu``, ``window_mult.cu``, ``scalar_mult.cu``), pow_planes'
K8', p - 2 chain and K8'' (``powchain.cu``), the field-multiply probe P
(``fieldmul_probe.cu``) and K9 (``majority.cu``); and the signer, the
batch verify, the setup and OM(m) by the EIG tree on the card.

These tests need a CUDA device and skip elsewhere.  On the card they
run without the repository's conftest (which configures jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

Tolerance is zero: every output is integer and must be bit-equal (the
Ed25519 kernels' points are canonical encodings, so they are too).
"""

import numpy as np
import pytest
import torch

from ba_tpu_torch import convert, native
from ba_tpu_torch.core import eig, rng
from ba_tpu_torch.core.state import make_state
from ba_tpu_torch.crypto import ed25519, oracle, scalar, sha512, signed
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.ops import (decompress, fieldmul_probe, ladder, majority, modl, powchain,
                              scenario_step, sha512_kernel, sweep_step, treeadd)
from ba_tpu_torch.parallel import pipeline
from ba_tpu_torch.scenario.compile import ScenarioBlock

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _arrays(seed, B, n, R):
    rs = np.random.default_rng(seed)
    state = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=rs.integers(0, n, B).astype(np.int32),
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
                              rs.integers(0, 6, (R, B, n)), -1).astype(np.int8),
    )
    strategy = rs.integers(0, 6, (B, n)).astype(np.int8)
    return state, events, strategy


def _carry(arrays, seed, device, counter):
    state = convert.state_from_numpy(type("S", (), arrays), device)
    sched = pipeline.make_key_schedule(rng.key(seed, device=device), counter)
    return state, sched


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("B,n,R,seed", [(7, 1, 3, 0), (16, 13, 5, 1), (9, 33, 4, 2),
                                        (32, 37, 6, 3), (3, 64, 2, 4)])
def test_scenario_megastep_bit_equal(cuda_device, B, n, R, seed):
    arrays, events, strategy = _arrays(seed, B, n, R)
    outs = []
    for fn in (pipeline.scenario_megastep, scenario_step.cuda_scenario_megastep):
        state, sched = _carry(arrays, seed, cuda_device, counter=2**31 - 3)
        before = scenario_step.cuda_scenario_megastep.launches
        out = fn(
            state, sched, convert.strategy_from_numpy(strategy, cuda_device),
            convert.counters_from_numpy(np.arange(5), cuda_device),
            convert.events_from_numpy(events, cuda_device),
            rounds=R, collect_decisions=True,
        )
        launched = scenario_step.cuda_scenario_megastep.launches - before
        assert launched == (fn is scenario_step.cuda_scenario_megastep)
        outs.append(out)
    plain, kernel = outs
    _same(plain[0].tensors(), kernel[0].tensors())
    assert torch.equal(plain[1].counter, kernel[1].counter)
    _same(plain[2:], kernel[2:])


def test_scenario_kernel_ignores_the_chain_flag(cuda_device):
    """Inside ``strategies.chain_impl()`` the torch engine takes the legacy
    select chains; K1 reads only its lie table and launches as before:
    all four legs bit-equal."""
    from ba_tpu_torch.scenario import strategies

    B, n, R, seed = 32, 37, 6, 3
    arrays, events, strategy = _arrays(seed, B, n, R)
    outs = []
    for chain in (False, True):
        for fn in (pipeline.scenario_megastep, scenario_step.cuda_scenario_megastep):
            state, sched = _carry(arrays, seed, cuda_device, counter=5)
            before = scenario_step.cuda_scenario_megastep.launches
            with strategies.chain_impl(chain):
                out = fn(state, sched, convert.strategy_from_numpy(strategy, cuda_device),
                         convert.counters_from_numpy(np.arange(5), cuda_device),
                         convert.events_from_numpy(events, cuda_device),
                         rounds=R, collect_decisions=True)
            launched = scenario_step.cuda_scenario_megastep.launches - before
            assert launched == (fn is scenario_step.cuda_scenario_megastep)
            outs.append(out)
    for other in outs[1:]:
        _same(outs[0][0].tensors(), other[0].tensors())
        _same(outs[0][2:], other[2:])


@pytest.mark.parametrize("with_counters", [False, True])
@pytest.mark.parametrize("B,n,R,seed", [(5, 1, 2, 5), (16, 17, 4, 6), (8, 40, 3, 7)])
def test_pipeline_megastep_bit_equal(cuda_device, B, n, R, seed, with_counters):
    arrays, _, _ = _arrays(seed, B, n, R)
    outs = []
    for fn in (pipeline.pipeline_megastep, scenario_step.cuda_pipeline_megastep):
        state, sched = _carry(arrays, seed, cuda_device, counter=11)
        counters = (
            convert.counters_from_numpy([4, 0, 9], cuda_device) if with_counters else None
        )
        outs.append(fn(state, sched, rounds=R, collect_decisions=True, counters=counters))
    plain, kernel = outs
    assert len(plain) == len(kernel)
    _same(plain[0].tensors(), kernel[0].tensors())
    _same(plain[2:], kernel[2:])


def test_sweeps_cuda_engine_equal_torch_engine(cuda_device):
    B, n, R = 12, 21, 7
    arrays, events, strategy = _arrays(9, B, n, R)
    block = ScenarioBlock(**events)
    res = {}
    for engine in ("torch", "cuda"):
        state, _ = _carry(arrays, 0, cuda_device, 0)
        plain = pipeline.pipeline_sweep(
            rng.key(3, device=cuda_device), state, R, depth=2,
            rounds_per_dispatch=3, collect_decisions=True, with_counters=True,
            engine=engine, device=cuda_device,
        )
        state, _ = _carry(arrays, 0, cuda_device, 0)
        scen = pipeline.scenario_sweep(
            rng.key(4, device=cuda_device), state, block, depth=2,
            rounds_per_dispatch=3, collect_decisions=True,
            initial_strategy=torch.tensor(strategy), engine=engine, device=cuda_device,
        )
        res[engine] = (plain, scen)
    for a, b in zip(res["torch"], res["cuda"]):
        for key in ("histograms", "decisions", "counters_per_round", "leaders"):
            if key in a:
                assert np.array_equal(a[key], b[key]), key
        _same(a["final_state"].tensors(), b["final_state"].tensors())
    assert res["cuda"][0]["stats"]["engine"] == "cuda"


def _slot_carry(arrays, seed, device, C, counter=2**31 - 2):
    """A coalesced cohort's carry: the state, a slot schedule with one key
    a slot (seed * 1000 + b) and random [B, C] counter blocks."""
    B = arrays["order"].shape[0]
    state = convert.state_from_numpy(type("S", (), arrays), device)
    keys = torch.stack([rng.key(seed * 1000 + b, device="cpu") for b in range(B)])
    sched = convert.slot_schedule_from_numpy(keys.numpy(), counter, device)
    block = np.random.default_rng(seed).integers(0, 50, (B, C))
    return state, sched, convert.slot_counters_from_numpy(block, device)


def _coalesced(fn, arrays, events, strategy, seed, device, R, scenario):
    state, sched, counters = _slot_carry(arrays, seed, device, 5 if scenario else 3)
    strat = convert.strategy_from_numpy(strategy, device) if scenario else None
    ev = convert.events_from_numpy(events, device) if scenario else None
    out = fn(state, sched, strat, counters, ev, rounds=R, scenario=scenario)
    return (*out[0].tensors(), out[1].counter, *out[2:])


@pytest.mark.parametrize("scenario", [False, True])
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("n", [4, 33, 300])
def test_coalesced_megastep_bit_equal(cuda_device, B, n, scenario):
    """K1's slot mode against the plain ``coalesced_megastep``: the carry,
    the counter, the strategy plane, every column of the last round's
    majorities, decisions, per-slot counter rows and leaders."""
    R, seed = 5, B + n
    arrays, events, strategy = _arrays(seed, B, n, R)
    before = scenario_step.cuda_coalesced_megastep.launches
    plain = _coalesced(pipeline.coalesced_megastep, arrays, events, strategy, seed,
                       cuda_device, R, scenario)
    kernel = _coalesced(scenario_step.cuda_coalesced_megastep, arrays, events, strategy,
                        seed, cuda_device, R, scenario)
    assert scenario_step.cuda_coalesced_megastep.launches == before + 1
    assert len(plain) == len(kernel) == (11 if scenario else 10)
    _same(plain, kernel)


def test_coalesced_slot_alone_equals_cohort_and_dead_askers(cuda_device):
    """Every slot of a B = 64 cohort through K1's slot mode equals that
    slot run alone (B = 1) through the kernel, and the plain version; the
    last round's majorities of dead generals are compared, and some of
    them are decided values (their coins were drawn)."""
    B, n, R, seed = 64, 33, 4, 71
    arrays, events, strategy = _arrays(seed, B, n, R)
    co = _coalesced(scenario_step.cuda_coalesced_megastep, arrays, events, strategy, seed,
                    cuda_device, R, True)
    plain = _coalesced(pipeline.coalesced_megastep, arrays, events, strategy, seed,
                       cuda_device, R, True)
    _same(co, plain)
    state, sched, counters = _slot_carry(arrays, seed, cuda_device, 5)
    for b in range(B):
        one = {k: v[b:b + 1] for k, v in arrays.items()}
        ev = convert.events_from_numpy({k: v[:, b:b + 1] for k, v in events.items()},
                                       cuda_device)
        alone = scenario_step.cuda_coalesced_megastep(
            convert.state_from_numpy(type("S", (), one), cuda_device),
            pipeline.KeySchedule(sched.key_data[b:b + 1].clone(), sched.counter.clone()),
            convert.strategy_from_numpy(strategy[b:b + 1], cuda_device),
            counters[b:b + 1].clone(), ev, rounds=R, scenario=True)
        # majorities [1, n], decisions, counter rows and leaders [R, 1, ...]
        for got, want in zip(alone[3:], (co[7][b:b + 1], co[8][:, b:b + 1],
                                         co[9][:, b:b + 1], co[10][:, b:b + 1])):
            assert torch.equal(got, want), b
    maj, alive = co[7].cpu(), co[3].cpu()
    dead_maj = maj[~alive]
    assert dead_maj.numel() and bool((dead_maj != 2).any())


def test_coalesced_sweep_cuda_engine_equals_torch(cuda_device):
    B, n, R = 12, 21, 7
    arrays, events, strategy = _arrays(13, B, n, R)
    keys = [rng.key(40 + b, device="cpu") for b in range(B)]
    res = {}
    for engine in ("torch", "cuda"):
        for scenario in (None, events):
            state = convert.state_from_numpy(type("S", (), arrays), cuda_device)
            res[engine, scenario is None] = pipeline.coalesced_sweep(
                keys, state, R, rounds_per_dispatch=3, scenario=scenario,
                initial_strategy=None if scenario is None else strategy,
                engine=engine, device=cuda_device)
    for plain in (True, False):
        a, b = res["torch", plain], res["cuda", plain]
        for key in ("decisions", "majorities", "counters", "leaders"):
            if key in a:
                assert np.array_equal(a[key], b[key]), key
    assert res["cuda", True]["stats"]["engine"] == "cuda"


@pytest.mark.parametrize("depth", [1, 2])
def test_slot_graph_replay_matches_eager(cuda_device, depth):
    """A CUDA graph of K1's slot-mode dispatch (``obs/graphcache.py``)
    replayed by ``coalesced_sweep(executables=)`` gives the eager
    dispatches' bits: plain and scenario, windows 4, 4 and a ragged 2,
    depth 2 keeping a replay's outputs in flight while the next replays."""
    from ba_tpu_torch.obs.graphcache import GraphCache

    B, n, R, rpd = 8, 64, 10, 4
    arrays, events, strategy = _arrays(21, B, n, R)
    keys = [rng.key(70 + b, device="cpu") for b in range(B)]
    cache = GraphCache(cuda_device)
    scenario_step.reset_launches()
    for scenario in (False, True):
        for window in (rpd, R % rpd):
            info = cache.ensure("coalesced_megastep", {
                "batch": B, "capacity": n, "rounds": window, "m": 1, "max_liars": None,
                "unroll": 1, "scenario": scenario, "signed": False, "collapsed": False,
                "engine": "cuda"})
            assert info["graph"]
    assert cache.graphs() == 4
    # one eager launch a capture; the capture itself counts none
    assert scenario_step.cuda_coalesced_megastep.launches == 4
    for planes in (None, events):
        runs = []
        for executables in (None, cache, cache):
            state = convert.state_from_numpy(type("S", (), arrays), cuda_device)
            scenario_step.reset_launches()
            runs.append(pipeline.coalesced_sweep(
                keys, state, R, rounds_per_dispatch=rpd, depth=depth, scenario=planes,
                initial_strategy=None if planes is None else strategy, engine="cuda",
                device=cuda_device, executables=executables))
            # a replay counts one launch, as the eager dispatch does
            assert scenario_step.cuda_coalesced_megastep.launches == 3
        eager, warm, again = runs
        assert (warm["stats"]["warm_dispatches"], warm["stats"]["graph_fallbacks"]) == (3, 0)
        for key in ("decisions", "majorities", "counters", "leaders"):
            if key in eager:
                assert np.array_equal(eager[key], warm[key]), key
                assert np.array_equal(eager[key], again[key]), key


def test_coalesced_kernel_rejects_bad_inputs(cuda_device):
    arrays, events, strategy = _arrays(3, 4, 6, 2)
    state, sched, counters = _slot_carry(arrays, 3, cuda_device, 3)
    with pytest.raises(ValueError):  # a shared (2,) key in slot mode
        scenario_step.cuda_coalesced_megastep(
            state, pipeline.make_key_schedule(rng.key(0, device=cuda_device)), None,
            counters, None, rounds=2)
    with pytest.raises(ValueError):  # counters of the wrong width
        scenario_step.cuda_coalesced_megastep(state, sched, None, counters[:, :2], None,  # ba-lint: disable=BA201 (the call above raised first)
                                              rounds=2)
    with pytest.raises(ValueError):  # event planes without scenario mode
        scenario_step.cuda_coalesced_megastep(
            state, sched, None, counters, convert.events_from_numpy(events, cuda_device),  # ba-lint: disable=BA201 (the calls above raised first)
            rounds=2)


@pytest.mark.parametrize("mode", ["plain", "scenario", "slot"])
@pytest.mark.parametrize("n", [32, 128, 1024, 300, 1000])
def test_megastep_coin_layouts_bit_equal(cuda_device, n, mode):
    """K1's two layouts of the coin words against the torch engine in each
    mode: n a multiple of 32 (a warp a column, one bit transpose) and n
    not one (a warp 32 words, need windows and two transposes; at 300 and
    1000 each warp takes several groups of words, so its step from group
    to group is exercised); random leaders (faulty ones drawing round-1
    coins), strategies, events and an all-dead row; slot mode with every
    dead asker's last majority."""
    B, R, seed = 6, 3, n + 5
    arrays, events, strategy = _arrays(seed, B, n, R)
    if mode == "slot":
        before = scenario_step.cuda_coalesced_megastep.launches
        plain = _coalesced(pipeline.coalesced_megastep, arrays, events, strategy, seed,
                           cuda_device, R, True)
        kernel = _coalesced(scenario_step.cuda_coalesced_megastep, arrays, events, strategy,
                            seed, cuda_device, R, True)
        assert scenario_step.cuda_coalesced_megastep.launches == before + 1
        _same(plain, kernel)
        return
    outs = []
    for fn in ((pipeline.pipeline_megastep, scenario_step.cuda_pipeline_megastep)
               if mode == "plain" else
               (pipeline.scenario_megastep, scenario_step.cuda_scenario_megastep)):
        state, sched = _carry(arrays, seed, cuda_device, counter=2**31 - 2)
        if mode == "plain":
            out = fn(state, sched, rounds=R, collect_decisions=True,
                     counters=convert.counters_from_numpy([1, 0, 2], cuda_device))
        else:
            out = fn(state, sched, convert.strategy_from_numpy(strategy, cuda_device),
                     convert.counters_from_numpy(np.arange(5), cuda_device),
                     convert.events_from_numpy(events, cuda_device),
                     rounds=R, collect_decisions=True)
        outs.append((*out[0].tensors(), out[1].counter, *out[2:]))
    _same(*outs)


def test_kernel_rejects_a_bad_carry(cuda_device):
    arrays, _, _ = _arrays(1, 4, 8, 1)
    state, sched = _carry(arrays, 0, cuda_device, 0)
    bad = convert.state_from_numpy(type("S", (), arrays), cuda_device)
    bad = type(bad)(bad.order, bad.leader.long(), bad.faulty, bad.alive, bad.ids)
    with pytest.raises(ValueError):
        scenario_step.cuda_pipeline_megastep(bad, sched, rounds=1)


# -- K2, the fused signed-sweep step (csrc/sweep_step.cu) ----------------------


def _sweep_inputs(seed, B, n, device):
    rs = np.random.default_rng(seed)
    faulty = rs.random((B, n)) < 0.3
    faulty[::3, 0] = True  # faulty leaders in every third instance
    alive = rs.random((B, n)) < 0.8
    alive[1] = False  # an all-dead row decides UNDEFINED
    arrays = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=np.where(rs.random(B) < 0.5, 0, rs.integers(0, n, B)).astype(np.int32),
        faulty=faulty, alive=alive,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    st = convert.state_from_numpy(type("S", (), arrays), device)
    ok = torch.tensor(rs.random((B, 2)) < 0.85, device=device)
    seed_t = torch.tensor([int(rs.integers(-2**31, 2**31))], dtype=torch.int32, device=device)
    return seed_t, st, ok


@pytest.mark.parametrize("rounds", [1, 15, 16, 35])
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 37, 128, 1024])
def test_sweep_step_kernel_bit_equal(cuda_device, n, m, rounds):
    B = 37  # not a multiple of the four instances a block
    seed, st, ok = _sweep_inputs(n * 100 + m * 10 + rounds, B, n, cuda_device)
    args = (seed, st.order, st.leader, st.faulty, st.alive, ok, m, rounds)
    before = sweep_step.fused_signed_sweep_step.launches
    got = sweep_step.fused_signed_sweep_step(*args)
    assert sweep_step.fused_signed_sweep_step.launches == before + 1
    want = sweep_step.plain_fused_signed_sweep_step(*args)
    torch.cuda.synchronize()
    assert got.shape == ((B,) if rounds == 1 else (B, rounds))
    assert torch.equal(got.cpu(), want.cpu())


def _draw_inputs(seed, B, n, device):
    """Few generals, every leader faulty, one traitor lieutenant at least,
    valid tables and a dead general in every third instance: round-1
    coins and relay draws decide the rounds."""
    rs = np.random.default_rng(seed)
    leader = rs.integers(0, n, B).astype(np.int32)
    faulty = rs.random((B, n)) < 0.3
    faulty[np.arange(B), leader] = True
    faulty[np.arange(B), (leader + 1 + rs.integers(0, n - 1, B)) % n] = True
    alive = np.ones((B, n), bool)
    alive[::3, (leader[::3] + 2) % n] = False
    arrays = dict(order=rs.integers(0, 2, B).astype(np.int8), leader=leader, faulty=faulty,
                  alive=alive, ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)))
    st = convert.state_from_numpy(type("S", (), arrays), device)
    ok = torch.ones((B, 2), dtype=torch.bool, device=device)
    seed_t = torch.tensor([int(rs.integers(-2**31, 2**31))], dtype=torch.int32, device=device)
    return seed_t, st, ok


@pytest.mark.parametrize("rounds", [1, 35])
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("n", [4, 5, 6, 7, 8])
def test_sweep_step_kernel_bit_equal_where_draws_decide(cuda_device, n, m, rounds):
    B = 37
    seed, st, ok = _draw_inputs(n * 100 + m * 10 + rounds, B, n, cuda_device)
    args = (seed, st.order, st.leader, st.faulty, st.alive, ok, m, rounds)
    got = sweep_step.fused_signed_sweep_step(*args)
    want = sweep_step.plain_fused_signed_sweep_step(*args)
    other = sweep_step.plain_fused_signed_sweep_step(seed ^ 1, *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert (other != want).any()  # the draws decided what was compared


@pytest.mark.parametrize("rounds", [1, 35])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [512, 513])
def test_sweep_step_kernel_bit_equal_at_bucket_edges(cuda_device, n, m, rounds):
    """K2 at n = 512 (16 lanes an instance, two instances a warp) and 513
    (a whole warp), B = 37 (not a multiple of the instances a warp or a
    block), faulty leaders in every third instance and in every fourth
    only 4 to 8 generals alive with a traitor lieutenant, so draws decide
    some rounds."""
    B = 37
    seed, st, ok = _sweep_inputs(n * 10 + m + rounds, B, n, cuda_device)
    rs = np.random.default_rng(n + m)
    alive, faulty, leader = st.alive.clone(), st.faulty.clone(), st.leader.clone()
    for b in range(2, B, 4):
        slots = torch.tensor(rs.choice(n, int(rs.integers(4, 9)), replace=False),
                             device=cuda_device)
        alive[b] = False
        alive[b, slots] = True
        faulty[b, slots[:2]] = True
        leader[b] = slots[0]
    ok[2::4] = True
    args = (seed, st.order, leader, faulty, alive, ok, m, rounds)
    got = sweep_step.fused_signed_sweep_step(*args)
    want = sweep_step.plain_fused_signed_sweep_step(*args)
    other = sweep_step.plain_fused_signed_sweep_step(seed ^ 1, *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert (other != want).any()  # the draws decided what was compared


@pytest.mark.parametrize("index_base", [1, 37, 2**31 - 40])
@pytest.mark.parametrize("n", [6, 513])
def test_sweep_step_kernel_index_base(cuda_device, n, index_base):
    """K2's ``index_base`` keys row i's Philox stream by instance
    ``index_base + i``, as the plain version does; the sharded form on a
    mesh of ``cuda_device`` repeated is the unsharded launch's bits."""
    from ba_tpu_torch.parallel.mesh import make_mesh

    B, m, rounds = 36, 3, 35
    seed, st, ok = _draw_inputs(n + index_base % 97, B, 6, cuda_device)
    pad = torch.zeros((B, n - 6), dtype=torch.bool, device=cuda_device)  # dead generals
    faulty, alive = torch.cat([st.faulty, pad], 1), torch.cat([st.alive, pad], 1)
    args = (seed, st.order, st.leader, faulty, alive, ok, m, rounds)
    got = sweep_step.fused_signed_sweep_step(*args, index_base=index_base)
    want = sweep_step.plain_fused_signed_sweep_step(*args, index_base=index_base)
    at_zero = sweep_step.plain_fused_signed_sweep_step(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert (at_zero != want).any()  # the offset moved the draws that decide
    whole = sweep_step.fused_signed_sweep_step(*args)
    for d in (1, 4):
        before = sweep_step.fused_signed_sweep_step.launches
        sharded = sweep_step.fused_sharded_sweep_step(
            make_mesh((d, 1), devices=[cuda_device] * d), *args)
        assert sweep_step.fused_signed_sweep_step.launches == before + d
        assert torch.equal(sharded.gather().cpu(), whole.cpu())


def test_kernel_philox_known_answers(cuda_device):
    """Random123's known answers through the Philox rounds of the kernel's
    own source."""
    words = torch.tensor([[0] * 6, [0xFFFFFFFF] * 6], dtype=torch.int64, device=cuda_device)
    assert sweep_step.kernel_philox4x32_10(words).tolist() == [
        [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
        [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]]


def test_sweep_step_kernel_rejects_bad_inputs(cuda_device):
    seed, st, ok = _sweep_inputs(0, 8, 16, cuda_device)
    with pytest.raises(ValueError):
        sweep_step.fused_signed_sweep_step(seed, st.order.int(), st.leader, st.faulty,
                                           st.alive, ok, 3, 4)
    with pytest.raises(ValueError):
        sweep_step.fused_signed_sweep_step(seed, st.order, st.leader, st.faulty, st.alive,
                                           ok, 3, 1921)


# -- K7, K5, K4, K3: the Ed25519 table verify ----------------------------------


def _le(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), np.uint8)


def _encodings(seed: int, S: int) -> np.ndarray:
    """Edge encodings (y at p - 1, p, 2p - 2, x = 0 with sign 1), keys of
    the native signer and random bytes: uint8 [S, 32]."""
    P = oracle.P
    rows = [_le(v) for v in (0, 1, P - 1, P, 2 * P - 2, 1 | (1 << 255))]
    _, pks = signed.commander_keys(max(S // 2, 1), seed)
    rs = np.random.default_rng(seed)
    rows = np.concatenate([np.stack(rows), pks, rs.integers(0, 256, (S, 32), dtype=np.uint8)])
    return np.ascontiguousarray(rows[:S])


def _scalar_bytes(seed: int, S: int) -> np.ndarray:
    L = oracle.L
    rs = np.random.default_rng(seed)
    vals = [0, 1, 15, 16, L - 1] + [int.from_bytes(rs.bytes(32), "little") % L for _ in range(S)]
    return np.ascontiguousarray(np.stack([_le(v) for v in vals[:S]]))


def _fixed_base_scalars(seed: int, S: int) -> np.ndarray:
    """K4's edge scalars (the recoding's: every nibble 8, the top nibble at
    8 and 15, which carry a 65th digit; L and 2^256 - 1), then random
    32-byte values, cut to S."""
    L = oracle.L
    edges = [0, 1, 8, 15, 16, L - 1, L, 2**256 - 1, int("8" * 64, 16), (8 << 252) | 5,
             (15 << 252) | (L - 1)]
    rand = np.random.default_rng(seed).integers(0, 256, (S, 32), dtype=np.uint8)
    return np.ascontiguousarray(np.concatenate([np.stack([_le(v) for v in edges]), rand])[:S])


@pytest.mark.parametrize("S", [1, 37, 300])
def test_decompress_kernel_bit_equal(cuda_device, S):
    enc = torch.tensor(_encodings(S, S), device=cuda_device)
    before = decompress.decompress.launches
    pts, ok = decompress.decompress(enc)
    assert decompress.decompress.launches == before + 1
    want_pts, want_ok = decompress.plain_decompress(enc)
    torch.cuda.synchronize()
    assert torch.equal(pts, want_pts) and torch.equal(ok, want_ok)


@pytest.mark.parametrize("nbytes", [0, 80, 200, 240])  # 1, 1, 2 and 3 blocks
@pytest.mark.parametrize("S", [1, 37, 127, 128, 129, 300, 1024, 20_480])
def test_sha512_modl_kernel_bit_equal(cuda_device, S, nbytes):
    msg = np.random.default_rng(S + nbytes).integers(0, 256, (S, nbytes), dtype=np.uint8)
    wh, wl, nb = sha512._message_words(torch.tensor(msg, device=cuda_device))
    before = sha512_kernel.sha512_blocks_mod_l.launches
    got = sha512_kernel.sha512_blocks_mod_l(wh, wl, nb)
    assert sha512_kernel.sha512_blocks_mod_l.launches == before + 1
    want = sha512_kernel.plain_sha512_blocks_mod_l(wh, wl, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 37, 300])
def test_fixed_base_kernel_bit_equal(cuda_device, S):
    """K4 at every thread count a lane, and at the wrapper's own, on the
    edge scalars and random ones: bit-equal to the plain fold."""
    s_enc = torch.tensor(_fixed_base_scalars(S, S), device=cuda_device)
    table = ed25519.fixed_base_table(cuda_device)
    want = treeadd.plain_fixed_base_fold(s_enc, table)
    for threads in (None, *treeadd.THREADS):
        before = treeadd.fixed_base_fold.launches
        got = treeadd.fixed_base_fold(s_enc, table, threads=threads)
        assert treeadd.fixed_base_fold.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), threads


@pytest.mark.parametrize("S", [1, 37, 300])
def test_window_verify_kernel_bit_equal(cuda_device, S):
    """Real signatures, half with a corrupted S (and so a wrong [S]B)."""
    sks, pks = signed.commander_keys(S, S)
    msgs, sigs = signed.sign_value_tables(sks, pks, n_values=1)
    sigs = sigs[:, 0].copy()
    sigs[1::2, 40] ^= 1
    dev = cuda_device
    pk, sig = torch.tensor(pks, device=dev), torch.tensor(sigs, device=dev)
    msg = torch.tensor(msgs[:, 0], device=dev)
    pts, _ = decompress.decompress(torch.cat([pk, sig[:, :32]]))
    h = sha512.sha512_mod_l(torch.cat([sig[:, :32], pk, msg], dim=1))
    left = ed25519.fixed_base_mult(sig[:, 32:])
    before = ladder.window_verify.launches
    got = ladder.window_verify(pts[:S], h, pts[S:], left)
    assert ladder.window_verify.launches == before + 1
    want = ladder.plain_window_verify(pts[:S], h, pts[S:], left)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[0::2].all() and not got[1::2].any()


def test_table_verify_on_card_matches_host(cuda_device):
    sks, pks = signed.commander_keys(64, 9)
    msgs, sigs = signed.sign_value_tables(sks, pks)
    sigs = sigs.copy()
    sigs[::5, 0, 7] ^= 1
    sigs[1::5, 1, 45] ^= 1
    got = signed.verify_received(pks, msgs, sigs, device=cuda_device)
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), signed.verify_host_exact(pks, msgs, sigs))
    on_card = [torch.tensor(a, device=cuda_device) for a in (pks, msgs, sigs)]
    assert torch.equal(signed.verify_received(*on_card, device=cuda_device), got)


def test_table_verify_queues_without_waiting(cuda_device):
    """The setup overlaps host signing with the card's verify only if
    queueing a verify never waits for the card: no stream sync and no
    blocking copy, from host arrays (pinned uploads) or card tensors."""
    sks, pks = signed.commander_keys(16, 3)
    msgs, sigs = signed.sign_value_tables(sks, pks)
    on_card = [torch.tensor(a, device=cuda_device) for a in (pks, msgs, sigs)]
    signed.verify_received(pks, msgs, sigs, device=cuda_device)  # builds, caches the table
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        from_host = signed.verify_received(pks, msgs, sigs, device=cuda_device)
        from_card = signed.verify_received(*on_card, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert from_host.all() and from_card.all()


def test_ed25519_kernels_reject_bad_inputs(cuda_device):
    enc = torch.zeros((4, 32), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        decompress.decompress(enc.int())
    with pytest.raises(ValueError):
        treeadd.fixed_base_fold(enc, ed25519.fixed_base_table(cuda_device)[:32])
    pts = torch.zeros((4, 4, 32), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        ladder.window_verify(pts, enc[:3], pts, pts)
    with pytest.raises(ValueError):
        ladder.window_verify(pts, enc.t().contiguous().t(), pts, pts)


# -- K5', K6, K8: device signing ------------------------------------------------


@pytest.mark.parametrize("nbytes", [0, 32, 112, 300])
@pytest.mark.parametrize("S", [1, 37, 300])
def test_sha512_kernel_bit_equal(cuda_device, S, nbytes):
    msg = np.random.default_rng(S + nbytes).integers(0, 256, (S, nbytes), dtype=np.uint8)
    wh, wl, nb = sha512._message_words(torch.tensor(msg, device=cuda_device))
    before = sha512_kernel.sha512_blocks.launches
    got = sha512_kernel.sha512_blocks(wh, wl, nb)
    assert sha512_kernel.sha512_blocks.launches == before + 1
    want = sha512_kernel.plain_sha512_blocks(wh, wl, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 33, 20_480])
def test_sha512_kernel_bit_equal_signer_widths(cuda_device, S):
    """K5' at the signer's 32-byte messages: one lane, a warp and one
    more, the setup's width (32-thread blocks, the last one partial)."""
    msg = np.random.default_rng(S).integers(0, 256, (S, 32), dtype=np.uint8)
    wh, wl, nb = sha512._message_words(torch.tensor(msg, device=cuda_device))
    got = sha512_kernel.sha512_blocks(wh, wl, nb)
    want = sha512_kernel.plain_sha512_blocks(wh, wl, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _modl_edges() -> list:
    """0, all-0xFF, L - 1, L, 2L, muladd_bytes' largest value; for the word
    form: 2^256 m, kL and kL +- 1 up to the largest k, the first fold's
    most negative value (low half 0, high half all ones), all ones in one
    word."""
    L = oracle.L
    vals = [0, 2**512 - 1, L - 1, L, 2 * L, (2**256 - 1) * 2**256]
    vals += [m << 256 for m in (1, 2, 15, 16, 17)]
    vals += [k * L + e for k in (1, 2, 3, 2**256 // L, 2**512 // L) for e in (-1, 0, 1)]
    vals += [0xFFFFFFFF << (32 * i) for i in range(16)]
    return [np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals if v < 2**512]


@pytest.mark.parametrize("S", [1, 37, 127, 128, 129, 300, 1024, 20_480])
def test_modl_kernel_bit_equal(cuda_device, S):
    """The edge values of ``_modl_edges`` first, then random bytes."""
    rs = np.random.default_rng(S)
    h = np.concatenate([np.stack(_modl_edges()),
                        rs.integers(0, 256, (S, 64), dtype=np.uint8)])[:S]
    h = torch.tensor(np.ascontiguousarray(h), device=cuda_device)
    before = modl.reduce_mod_l_planes.launches
    got = modl.reduce_mod_l_planes(h)
    assert modl.reduce_mod_l_planes.launches == before + 1
    want = modl.plain_reduce_mod_l(h)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_modl_and_sha512_reject_unaligned_bases(cuda_device):
    """K6, K5 and K5' read a lane by 16-byte vectors: a base off a 16-byte
    boundary raises rather than launching."""
    S = 4
    h = torch.zeros(S * 64 + 1, dtype=torch.uint8, device=cuda_device)[1:].view(S, 64)
    with pytest.raises(ValueError, match="16-byte"):
        modl.reduce_mod_l_planes(h)
    wh, wl, nb = sha512._message_words(torch.zeros((S, 80), dtype=torch.uint8,
                                                   device=cuda_device))
    off = torch.zeros(S * nb * 16 + 1, dtype=torch.int64, device=cuda_device)[1:]
    off = off.view(S, nb, 16).copy_(wh)
    for fn in (sha512_kernel.sha512_blocks_mod_l, sha512_kernel.sha512_blocks):
        with pytest.raises(ValueError, match="16-byte"):
            fn(off, wl, nb)
        with pytest.raises(ValueError, match="16-byte"):
            fn(wh, off, nb)


@pytest.mark.parametrize("S", [1, 2, 37, 300, 20_480])
def test_compress_inv_chain_kernel_bit_equal(cuda_device, S):
    """The identity, B, then [s]B from K4 (Z != 1)."""
    dev = cuda_device
    ends = torch.cat([ed25519.encode_point(ed25519.identity((1,), dev)),
                      ed25519.encode_point(ed25519.base_point((1,), dev))])
    s_enc = torch.tensor(_scalar_bytes(S + 1, S), device=dev)
    pts = torch.cat([ends, ed25519.fixed_base_mult(s_enc)])[:S].contiguous()
    before = powchain.compress.launches
    got = powchain.compress(pts)
    assert powchain.compress.launches == before + 1
    want = powchain.plain_compress(pts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


COMPRESS_Z = [0, 1, 2, 19, oracle.P - 1, oracle.P, oracle.P + 1, 2**255 - 1, 2**255,
              2**256 - 1]


@pytest.mark.parametrize("S", [2, 20_480])
def test_compress_kernel_z_edges_bit_equal(cuda_device, S):
    """K8 launched at the paths' lane counts (2 lanes a launch over the edge
    rows, or all of them in one launch of 20 480) on random X, Y and Z in
    0, 1, 2, 19, p - 1, p, p + 1, 2^255 - 1, 2^255, 2^256 - 1 and random:
    bit-equal to the plain version on the coordinates' low 255 bits (what
    the kernel reads)."""
    rs = np.random.default_rng(S)
    pts = rs.integers(0, 256, (max(S, len(COMPRESS_Z)), 4, 32), dtype=np.uint8)
    pts[: len(COMPRESS_Z), 2] = np.stack([_le(z % 2**256) for z in COMPRESS_Z])
    pts = torch.tensor(pts)
    low = pts.clone()
    low[:, :3, 31] &= 0x7F
    want = powchain.plain_compress(low)
    card = pts.to(cuda_device)
    got = torch.cat([powchain.compress(card[i:i + S]) for i in range(0, len(card), S)])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _sign_inputs(seed: int, S: int):
    sks, pks = signed.commander_keys(S, seed)
    sks[0] = bytes(32)
    pks[0] = np.frombuffer(oracle.publickey(sks[0]), np.uint8)
    msgs = signed._value_table_msgs(S, 1, seed)[:, 0]
    return np.stack([np.frombuffer(s, np.uint8) for s in sks]), pks, msgs


@pytest.mark.parametrize("S", [1, 37, 300])
def test_sign_on_card_matches_native_signer(cuda_device, S):
    """Six launches: K5' once, K5 twice, K4, K8 and K6 once each."""
    sk, pk, msg = _sign_inputs(S, S)
    counters = (sha512_kernel.sha512_blocks, sha512_kernel.sha512_blocks_mod_l,
                treeadd.fixed_base_fold, powchain.compress, modl.reduce_mod_l_planes)
    before = [fn.launches for fn in counters]
    got = ed25519.sign(*(torch.tensor(a, device=cuda_device) for a in (sk, pk, msg)))
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 2, 1, 1, 1]
    assert np.array_equal(got.cpu().numpy(), native.sign_batch(sk, pk, msg))


def test_sign_muladd_bytes_on_card_matches_cpu(cuda_device):
    rs = np.random.default_rng(8)
    k, a, r = (rs.integers(0, 256, (64, 32), dtype=np.uint8) for _ in range(3))
    k[0] = a[0] = r[0] = 255
    want = scalar.muladd_bytes(*(torch.tensor(x) for x in (k, a, r)))
    got = scalar.muladd_bytes(*(torch.tensor(x, device=cuda_device) for x in (k, a, r)))
    assert torch.equal(got.cpu(), want)


def test_device_sign_setup_matches_host_signer(cuda_device):
    sks, pks, msgs, sigs, ok, t = signed.setup_signed_tables(40, seed=6, device=cuda_device)
    assert t["device_sign"] is True and t["chunks"] == 1 and t["verify_route"] == "device"
    want_m, want_s = signed.sign_value_tables(sks, pks)
    assert np.array_equal(msgs, want_m) and np.array_equal(sigs, want_s)
    assert ok.device.type == "cuda" and bool(ok.all())


def test_device_sign_setup_queues_without_waiting(cuda_device):
    """Keys on the host, then signing and the table verify queued with no
    stream sync and no blocking copy, up to the one fetch."""
    signed.setup_signed_tables(16, seed=1, device=cuda_device)  # builds, caches the table
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        queued = signed.queue_signed_tables(16, seed=2, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sks, pks, msgs, sigs, ok, t = signed.drain_signed_tables(queued)
    assert t["device_sign"] is True and bool(ok.all())
    assert np.array_equal(sigs, signed.sign_value_tables(sks, pks)[1])


# -- K3', P: the batch verify and the field-multiply probe ------------------------


def _window_points(S: int, dev) -> torch.Tensor:
    """The identity, B, then [s]B from K4 (Z != 1) and decompressed keys."""
    ends = torch.cat([ed25519.encode_point(ed25519.identity((1,), dev)),
                      ed25519.encode_point(ed25519.base_point((1,), dev))])
    sb = ed25519.fixed_base_mult(torch.tensor(_scalar_bytes(S + 3, S), device=dev))
    keys = torch.tensor(signed.commander_keys(S, S)[1], device=dev)
    return torch.cat([ends, sb[: S // 2], decompress.decompress(keys)[0]])[:S].contiguous()


def _window_scalars(S: int, nbytes: int) -> np.ndarray:
    """0, 1, 8, 15, 16, L - 1 (cut to nbytes), all ones, top nibbles of 8
    and 15 (the signed recoding carries out of the top), then random."""
    top = 2 ** (8 * nbytes) - 1
    edges = [0, 1, 8, 15, 16, (oracle.L - 1) & top, top, 8 << (8 * nbytes - 4),
             15 << (8 * nbytes - 4)]
    rows = [np.frombuffer(v.to_bytes(nbytes, "little"), np.uint8) for v in edges]
    rows += list(np.random.default_rng(S + nbytes).integers(0, 256, (S, nbytes), dtype=np.uint8))
    return np.ascontiguousarray(np.stack(rows[:S]))


@pytest.mark.parametrize("S", [1, 37, 300])
def test_window_mult_kernel_bit_equal(cuda_device, S):
    pts = _window_points(S, cuda_device)
    k = torch.tensor(_window_scalars(S, 32), device=cuda_device)
    before = ladder.window_mult.launches
    got = ladder.window_mult(pts, k)
    assert ladder.window_mult.launches == before + 1
    want = ladder.plain_window_mult(pts, k)
    torch.cuda.synchronize()
    assert got.shape == (S, 4, 32) and torch.equal(got, want)


def test_window_lanes_warp_point_kernel_bit_equal(cuda_device):
    """K3' and K3 where warps hold one point (lanes 0-31 and 64-69: the
    warp's one table, signed 4-bit windows) and where they do not (lanes
    32-63): bit-equal to the plain versions, which pick the same chain."""
    S = 70
    pts = _window_points(S, cuda_device).clone()
    pts[:32] = pts[3]
    pts[64:] = pts[40]
    assert ladder.warp_point_lanes(pts).tolist() == [True] * 32 + [False] * 32 + [True] * 6
    k = torch.tensor(_window_scalars(S, 32), device=cuda_device)
    got = ladder.window_mult(pts, k)
    assert torch.equal(got, ladder.plain_window_mult(pts, k))
    r = _window_points(S, cuda_device)
    ok = ladder.window_verify(pts, k, r, got)
    assert torch.equal(ok, ladder.plain_window_verify(pts, k, r, got))


@pytest.mark.parametrize("nz,na", [(1, 0), (0, 1), (37, 5), (300, 64), (2048, 33), (65, 1)])
def test_window_mult_sum8_kernel_bit_equal(cuda_device, nz, na):
    """K3''s sum: the R set (16-byte z) and the A set (32-byte w), either
    empty, ragged blocks, and 65 + 2 blocks (an odd node at most levels
    of the tree)."""
    r = _window_points(max(nz, 1), cuda_device)[:nz]
    z = torch.tensor(_window_scalars(max(nz, 1), 16), device=cuda_device)[:nz]
    a = _window_points(max(na, 1), cuda_device)[:na]
    w = torch.tensor(_window_scalars(max(na, 1), 32), device=cuda_device)[:na]
    before = ladder.window_mult_sum8.launches
    got = ladder.window_mult_sum8(r, z, a, w)
    assert ladder.window_mult_sum8.launches == before + 1
    want = ladder.plain_window_mult_sum8(r, z, a, w)
    torch.cuda.synchronize()
    assert got.shape == (1, 4, 32) and torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 37, 300])
def test_fieldmul_probe_kernel_bit_equal(cuda_device, S):
    rs = np.random.default_rng(S)
    a, b = (torch.tensor(rs.integers(0, 256, (S, 32), dtype=np.uint8), device=cuda_device)
            for _ in range(2))
    before = fieldmul_probe.fieldmul_probe.launches
    got = fieldmul_probe.fieldmul_probe(a, b)
    assert fieldmul_probe.fieldmul_probe.launches == before + 1
    want = fieldmul_probe.plain_fieldmul_probe(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("nbytes", [16, 32])
def test_window_mult_instance_bit_equal(cuda_device, nbytes):
    """K3''s instances at a full warp and a ragged one: a 32-byte k per
    lane, the sum's 16-byte (R set) and 32-byte (A set) lanes, against
    the plain version; a length K3' is not built for raises on the card
    (the plain version takes it on the CPU)."""
    S = 65
    pts = _window_points(S, cuda_device)
    k = torch.tensor(_window_scalars(S, nbytes), device=cuda_device)
    none = (pts[:0], torch.zeros((0, 48 - nbytes), dtype=torch.uint8, device=cuda_device))
    sets = (pts, k, *none) if nbytes == 16 else (*none, pts, k)
    assert torch.equal(ladder.window_mult_sum8(*sets), ladder.plain_window_mult_sum8(*sets))
    if nbytes == 32:
        assert torch.equal(ladder.window_mult(pts, k), ladder.plain_window_mult(pts, k))
    with pytest.raises(ValueError):
        ladder.window_mult(pts, k[:, :nbytes - 1])
    assert ladder.window_mult(pts.cpu(), k[:, :nbytes - 1].cpu()).shape == (S, 4, 32)


def test_window_mult_kernel_rejects_bad_inputs(cuda_device):
    pts = torch.zeros((4, 4, 32), dtype=torch.uint8, device=cuda_device)
    k = torch.zeros((4, 32), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        ladder.window_mult(pts, k[:3])
    with pytest.raises(ValueError):
        ladder.window_mult(pts, k[:, :0])
    with pytest.raises(ValueError):
        ladder.window_mult(pts, k.int())
    with pytest.raises(ValueError):
        ladder.window_mult_sum8(pts[:0], k[:0, :16], pts[:0], k[:0])
    with pytest.raises(ValueError):
        ladder.window_mult_sum8(pts, k, pts, k)  # z of 32 bytes
    with pytest.raises(ValueError):
        ladder.window_mult_sum8(pts, k[:, :16], pts, k.t().contiguous().t())
    with pytest.raises(ValueError):
        fieldmul_probe.fieldmul_probe(k[:, :16], k[:, :16])


def _rlc_batch(dev, B=8, n=8, seed=31):
    sks, pks = signed.commander_keys(B, seed)
    received = np.random.default_rng(seed).integers(0, 2, (B, n))
    msgs, sigs = signed.sign_received(sks, pks, received)
    return [torch.tensor(a, device=dev) for a in
            (np.repeat(pks, n, axis=0), msgs.reshape(B * n, -1), sigs.reshape(B * n, 64))]


def test_verify_rlc_on_card_known_answers(cuda_device):
    """A valid batch accepts (keys shared by 8 lanes, and unshared); one
    flipped signature byte rejects; S >= L is flagged and rejects; each
    verdict equals the plain version's on the same coefficients."""
    pk, msg, sig = _rlc_batch(cuda_device)
    z = torch.tensor(signed.fresh_rlc_coeffs(64), device=cuda_device)

    def both(sig_, group):
        got = ed25519.verify_rlc(pk, msg, sig_, z, pk_group=group)
        want = ed25519.verify_rlc(pk.cpu(), msg.cpu(), sig_.cpu(), z.cpu(), pk_group=group)
        assert bool(got[0]) == bool(want[0]) and torch.equal(got[1].cpu(), want[1])
        return bool(got[0]), got[1].cpu()

    counts = [ladder.window_mult.launches, ladder.window_mult_sum8.launches,
              powchain.compress.launches]
    ok, enc = both(sig, 8)
    assert ok and bool(enc.all())
    assert [ladder.window_mult.launches - counts[0], ladder.window_mult_sum8.launches - counts[1],
            powchain.compress.launches - counts[2]] == [0, 1, 1]
    assert both(sig, 1)[0]
    bad = sig.clone()
    bad[9, 40] ^= 1
    ok, enc = both(bad, 8)
    assert not ok and bool(enc.all())
    big = sig.clone()
    big[20, 32:] = 0xFF
    ok, enc = both(big, 8)
    assert not ok and not enc[20] and int(enc.sum()) == 63


def test_verify_received_rlc_on_card_matches_host(cuda_device):
    sks, pks = signed.commander_keys(16, 4)
    received = np.random.default_rng(4).integers(0, 2, (16, 4))
    msgs, sigs = signed.sign_received(sks, pks, received)
    got = signed.verify_received(pks, msgs, sigs, device=cuda_device, verify="rlc")
    assert got.device.type == "cuda" and bool(got.all())
    sigs[3, 2, 7] ^= 1
    got = signed.verify_received(pks, msgs, sigs, device=cuda_device, verify="rlc")
    assert np.array_equal(got.cpu().numpy(), signed.verify_host_exact(pks, msgs, sigs))


def test_rlc_setup_queues_without_waiting(cuda_device):
    """The "rlc" setup: keys on the host, then signing and one batch check
    queued with no stream sync and no blocking copy, up to the one fetch,
    which brings the batch verdict with the signatures."""
    signed.setup_signed_tables(16, seed=1, device=cuda_device, verify="rlc")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        queued = signed.queue_signed_tables(16, seed=2, device=cuda_device, verify="rlc")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sks, pks, msgs, sigs, ok, t = signed.drain_signed_tables(queued)
    assert t["verify"] == "rlc" and t["device_sign"] is True and bool(ok.all())
    assert np.array_equal(sigs, signed.sign_value_tables(sks, pks)[1])


@pytest.mark.parametrize("K", [1, 7, 10, 33, 128, 1024, 1025])
@pytest.mark.parametrize("R", [1, 257, 70_001])
def test_majority_kernel_bit_equal(cuda_device, R, K):
    """K9 against its plain version: any int8 code, rows with no valid
    responder, exact ties; dense and shared-mask forms, and a base that
    is not 4-byte aligned (byte loads)."""
    rs = np.random.default_rng(R + K)
    a = torch.tensor(rs.integers(-4, 5, (R, K)).astype(np.int8))
    v = torch.tensor(rs.random((R, K)) < 0.5)
    v[0] = False
    if R > 1 and K % 2 == 0:
        a[1], v[1] = torch.arange(K) % 2, True  # an exact tie
    f = torch.tensor(rs.integers(0, 3, R).astype(np.int8))
    want = majority.plain_masked_majority_rows(a, v, f)
    before = majority.masked_majority_rows.launches
    got = majority.masked_majority_rows(a.to(cuda_device), v.to(cuda_device), f.to(cuda_device))
    torch.cuda.synchronize()
    assert majority.masked_majority_rows.launches == before + 1
    assert torch.equal(got.cpu(), want)
    buf = torch.empty(R * K + 1, dtype=torch.int8, device=cuda_device)
    buf[1:] = a.reshape(-1).to(cuda_device)
    off = majority.masked_majority_rows(buf[1:].view(R, K), v.to(cuda_device),
                                        f.to(cuda_device))
    assert torch.equal(off.cpu(), want)
    G, P = 7, 5
    a4 = torch.tensor(rs.integers(0, 3, (G, 3, P, K)).astype(np.int8))
    v4 = torch.tensor(rs.random((G, 1, P, K)) < 0.5)
    f4 = torch.tensor(rs.integers(0, 3, (G, 3, P)).astype(np.int8))
    got4 = majority.masked_majority_rows(a4.to(cuda_device), v4.to(cuda_device),
                                         f4.to(cuda_device))
    assert torch.equal(got4.cpu(), majority.plain_masked_majority_rows(a4, v4, f4))


# (G, S, P, K): config #2's two resolve levels (bench_om3_n10, B = 131 072,
# n = 10), eig_n1024's (B = 128, n = 1024), the m = 2 sweep's (B = 64,
# capacity 16), and tiles that stay inside one (g, s) run of P rows.
MAJ_PATH_SHAPES = [(131_072, 10, 10, 10), (131_072, 10, 1, 10), (128, 1024, 1, 1024),
                   (64, 16, 1, 16), (3, 4, 1100, 7), (5, 3, 129, 32)]


@pytest.mark.parametrize("G,S,P,K", MAJ_PATH_SHAPES)
def test_majority_kernel_path_shapes_bit_equal(cuda_device, G, S, P, K):
    """K9 at the paths' shapes in the shared-mask form, bit-equal to its
    plain version on the card, with the answers at a base that is not
    4-byte aligned too."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(G + S + P + K)
    a = torch.randint(-2, 4, (G, S, P, K), dtype=torch.int8, device=dev, generator=gen)
    v = torch.rand((G, 1, P, K), device=dev, generator=gen) < 0.5
    v[0, 0, 0] = False
    f = torch.randint(0, 3, (G, S, P), dtype=torch.int8, device=dev, generator=gen)
    want = majority.plain_masked_majority_rows(a, v, f)
    got = majority.masked_majority_rows(a, v, f)
    buf = torch.empty(a.numel() + 3, dtype=torch.int8, device=dev)
    buf[3:] = a.reshape(-1)
    off = majority.masked_majority_rows(buf[3:].view(a.shape), v, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(off, want)


def test_majority_kernel_rejects_bad_inputs(cuda_device):
    a = torch.zeros(4, 6, dtype=torch.int8, device=cuda_device)
    v = torch.ones(4, 6, dtype=torch.bool, device=cuda_device)
    f = torch.zeros(4, dtype=torch.int8, device=cuda_device)
    for bad in ((a.to(torch.int32), v, f), (a, v.to(torch.int8), f),
                (a.t().contiguous().t(), v, f), (a, v, f.cpu())):
        with pytest.raises(ValueError):
            majority.masked_majority_rows(*bad)
    big = torch.zeros(1, 1, 2**30, 1, dtype=torch.int8, device=cuda_device)  # P = 2^30
    with pytest.raises(ValueError):
        majority.masked_majority_rows(big, big.bool(), big[..., 0])


@pytest.mark.parametrize("fused", [True, False])
def test_eig_agreement_on_card_matches_cpu(cuda_device, fused):
    """BASELINE config #2's shape at B = 64 (one key over the batch) and
    OM(2) with one key a row: the card, through K9 at every resolve
    level, bit-equal to the CPU."""
    faulty = torch.zeros(64, 10, dtype=torch.bool)
    faulty[:, [2, 5, 7]] = True
    outs = []
    for dev in ("cpu", cuda_device):
        state = make_state(64, 10, order=1, faulty=faulty, device=dev)
        before = majority.masked_majority_rows.launches
        out = eig.eig_agreement(rng.key(5, device=dev), state, 3, 3, fused=fused)
        keys = rng.fold_in(rng.key(6, device=dev)[None, :], torch.arange(64, device=dev))
        row = eig.eig_round(keys, state, 2, 3, fused=fused)
        outs.append((out["majorities"].cpu(), out["decision"].cpu(), row.cpu(),
                     majority.masked_majority_rows.launches - before))
    assert all(torch.equal(a, b) for a, b in zip(outs[0][:3], outs[1][:3]))
    assert outs[0][3] == 0 and outs[1][3] == (2 if fused else 3) + (1 if fused else 2)
    assert (outs[1][1] == 1).all()


# -- K3'', K8', the p - 2 chain, K8'': scalar_mult and pow_planes -----------------


def _ladder_bits(S: int, nbits: int, dev) -> torch.Tensor:
    """0/1 int32 [S, nbits]: all zeros, all ones, a lone 1, then random."""
    bits = np.random.default_rng(S + nbits).integers(0, 2, (S, nbits)).astype(np.int32)
    bits[0], bits[1 % S] = 0, 1
    bits[2 % S] = 0
    bits[2 % S, 0] = 1
    return torch.tensor(bits, device=dev)


@pytest.mark.parametrize("nbits", [32, 256])
@pytest.mark.parametrize("S", [1, 37, 63, 65, 300])
def test_scalar_mult_kernel_bit_equal(cuda_device, S, nbits):
    pts = _window_points(S, cuda_device)
    bits = _ladder_bits(S, nbits, cuda_device)
    before = ladder.scalar_mult.launches
    got = ladder.scalar_mult(pts, bits)
    assert ladder.scalar_mult.launches == before + 1
    want = ladder.plain_scalar_mult(pts, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_scalar_mult_on_card_matches_cpu_at_512_bits(cuda_device):
    """ed25519.scalar_mult and scalar_mult_base through K3'' (bool bits,
    a batch of shape [5, 13]) against the CPU ladder: canonical X, Y, Z
    and T equal; the products are those of K3' (window_mult) as points."""
    S = 65
    pts = _window_points(S, cuda_device)
    bits = _ladder_bits(S, 512, cuda_device).bool()
    limbs = ed25519.decode_point(pts)
    before = ladder.scalar_mult.launches
    got = ed25519.scalar_mult(limbs, bits)
    base = ed25519.scalar_mult_base(bits[:, :64].reshape(5, 13, 64))
    assert ladder.scalar_mult.launches == before + 2
    want = ed25519.scalar_mult(tuple(c.cpu() for c in limbs), bits.cpu())
    want_base = ed25519.scalar_mult_base(bits[:, :64].reshape(5, 13, 64).cpu())
    for g, w in zip((*got, *base), (*want, *want_base)):
        assert torch.equal(F.canonical(g).cpu(), F.canonical(w))
    k = bits[:, :256].reshape(S, 32, 8).to(torch.int32)
    k = (k << torch.arange(8, device=cuda_device, dtype=torch.int32)).sum(-1).to(torch.uint8)
    windowed = ladder.window_mult(pts, k.contiguous())
    short = ladder.scalar_mult(pts, bits[:, :256])
    assert torch.equal(powchain.compress(windowed), powchain.compress(short))


def _field_encodings(S: int, dev) -> torch.Tensor:
    """0, 1, p - 1, p, 2^255 - 1, a value with bit 255 set, then random."""
    P = oracle.P
    rows = [np.frombuffer(v.to_bytes(32, "little"), np.uint8)
            for v in (0, 1, P - 1, P, 2**255 - 1, 5 | 1 << 255)]
    rows += list(np.random.default_rng(S).integers(0, 256, (S, 32), dtype=np.uint8))
    return torch.tensor(np.ascontiguousarray(np.stack(rows[:S])), device=dev)


@pytest.mark.parametrize("S", [1, 37, 300])
def test_pow_chain_kernels_bit_equal(cuda_device, S):
    """K8', the p - 2 chain and K8'' (exponents 0, 1, 37, (p - 5)/8, p - 1
    and one of 1 024 bits) against their plain versions."""
    a = _field_encodings(S, cuda_device)
    P = oracle.P
    for fn, plain in ((powchain.sqrt_chain, powchain.plain_sqrt_chain),
                      (powchain.inv_chain, powchain.plain_inv_chain)):
        before = fn.launches
        got = fn(a)
        assert fn.launches == before + 1
        assert torch.equal(got, plain(a))
    for e in (0, 1, 37, (P - 5) // 8, P - 1, 2**1023 + 5):
        before = powchain.pow_exp.launches
        got = powchain.pow_exp(a, e)
        assert powchain.pow_exp.launches == before + 1
        assert torch.equal(got, powchain.plain_pow_exp(a, e)), e


def test_pow_planes_on_card_matches_cpu(cuda_device):
    """pow_planes on limbs in [-8000, 8000): each route launches its own
    kernel, and the canonical output equals the CPU route's."""
    P = oracle.P
    a = np.random.default_rng(8).integers(-8000, 8000, (300, F.LIMBS)).astype(np.int32)
    for e, fn in (((P - 5) // 8, powchain.sqrt_chain), (P - 2, powchain.inv_chain),
                  (0, powchain.pow_exp), (2, powchain.pow_exp), (P - 3, powchain.pow_exp)):
        before = fn.launches
        got = powchain.pow_planes(torch.tensor(a, device=cuda_device), e)
        assert fn.launches == before + 1
        want = powchain.pow_planes(torch.tensor(a), e)
        assert torch.equal(F.canonical(got).cpu(), F.canonical(want)), e


def test_ladder_and_pow_queue_without_waiting(cuda_device):
    """K3'''s bit packing, K8'''s exponent words and pow_planes' canonical
    form need no host sync."""
    pts = _window_points(8, cuda_device)
    bits = _ladder_bits(8, 64, cuda_device)
    a = _field_encodings(8, cuda_device)
    ladder.scalar_mult(pts, bits)
    powchain.pow_exp(a, 2**200 + 3)
    powchain.pow_planes(F.from_bytes(a), oracle.P - 2)  # canonical's constants, once a device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ladder.scalar_mult(pts, bits)
        powchain.pow_exp(a, 2**200 + 3)
        powchain.pow_planes(F.from_bytes(a), oracle.P - 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_ladder_and_pow_kernels_reject_bad_inputs(cuda_device):
    pts = torch.zeros((4, 4, 32), dtype=torch.uint8, device=cuda_device)
    bits = torch.zeros((4, 32), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ladder.scalar_mult(pts, bits[:, :31])
    with pytest.raises(ValueError):
        ladder.scalar_mult(pts, bits.cpu())
    with pytest.raises(ValueError):
        ladder.scalar_mult(pts.int(), bits)
    a = torch.zeros((4, 32), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        powchain.pow_exp(a, 2**1024)
    with pytest.raises(ValueError):
        powchain.sqrt_chain(a.int())
    with pytest.raises(ValueError):
        powchain.inv_chain(a.t().contiguous().t())
