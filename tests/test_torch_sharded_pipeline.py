"""The mesh engine: ``pipeline_sweep(mesh=)`` and ``scenario_sweep(mesh=)``
on the port's 8- and 2-entry CPU meshes against ``ba_tpu``'s on its
8-device CPU mesh (``engine="xla"``) and against the unsharded run
(``tests/test_pipeline.py:310``, ``tests/test_scenario.py:802``);
carry checkpoints across device counts and packages (d = 8 -> 2 -> 1
both ways, headers equal); the engine rule, the eager mesh checks and
the dispatch trace on a live mesh.  Inputs come from numpy seeds;
tolerance zero."""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core.state import SimState as JState
from ba_tpu.parallel import make_mesh as j_make_mesh
from ba_tpu.parallel import pipeline as jp
from ba_tpu.parallel import shard as j_shard
from ba_tpu.scenario import compile as j_compile
from ba_tpu.scenario import spec as j_spec
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.parallel import make_mesh
from ba_tpu_torch.parallel import mesh as M
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.parallel import shard as t_shard
from ba_tpu_torch.utils.snapshot import validate_carry_checkpoint

CPU = torch.device("cpu")
B, N, R = 16, 8, 6
SPEC = {"name": "mesh-campaign", "rounds": 8, "order": "attack", "events": [
    {"round": 1, "kill": [1]}, {"round": 2, "set_faulty": [3], "value": True},
    {"round": 3, "set_strategy": [3], "value": "adaptive_split"},
    {"round": 5, "revive": [1], "instances": [0, 5, 9]},
    {"round": 6, "set_strategy": [4], "value": "silent"}]}


def _arrays(seed, faulty_leaders=True):
    rs = np.random.default_rng(seed)
    arrays = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=(rs.integers(0, N, B) if faulty_leaders else np.zeros(B)).astype(np.int32),
        faulty=rs.random((B, N)) < 0.3,
        alive=rs.random((B, N)) < 0.9,
        ids=np.tile(np.arange(1, N + 1, dtype=np.int32), (B, 1)),
    )
    return arrays, rs.integers(0, 5, (B, N)).astype(np.int8)


def _jstate(arrays):
    return JState(**{k: jnp.asarray(v).copy() for k, v in arrays.items()})


def _tstate(arrays):
    return convert.state_from_numpy(type("S", (), arrays), CPU)


def _mesh(d):
    return make_mesh((d, 1), devices=[CPU] * d)


@pytest.fixture(scope="module")
def j_mesh8(eight_devices):
    return j_make_mesh((8, 1), ("data", "node"))


def _same(a, b, names):
    for name in names:
        assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name


@pytest.mark.parametrize("m", [1, 2])
def test_pipeline_sweep_on_a_mesh_matches_the_reference(j_mesh8, m):
    arrays, _ = _arrays(1)
    kw = dict(m=m, depth=2, rounds_per_dispatch=4, collect_decisions=True, with_counters=True)
    names = ("histograms", "decisions", "counters_per_round")
    j_out = jp.pipeline_sweep(jr.key(21), _jstate(arrays), R, engine="xla", mesh=j_mesh8,
                              **kw)
    plain = tp.pipeline_sweep(rng.key(21, CPU), _tstate(arrays), R, device="cpu", **kw)
    for d in (8, 2):
        t_out = tp.pipeline_sweep(rng.key(21, CPU), _tstate(arrays), R, mesh=_mesh(d), **kw)
        _same(j_out, t_out, names)
        _same(plain, t_out, names)
        assert j_out["counters"] == t_out["counters"] == plain["counters"]
        assert t_out["final_counters"].shape == (d, 3)
        assert np.array_equal(np.asarray(t_out["final_counters"]).sum(0),
                              plain["final_counters"].numpy())
        stats = t_out["stats"]
        assert stats["shards"] == d and stats["engine"] == "torch"
        assert ("mesh data=" if m == 1 else "m=2") in stats["engine_fallback"]
        assert stats["carry_bytes_per_shard"] < plain["stats"]["carry_bytes_per_shard"]
        assert np.array_equal(np.asarray(t_out["final_state"].faulty), arrays["faulty"])
        assert int(np.asarray(t_out["final_schedule"].counter)) == R
    assert j_out["stats"]["shards"] == 8


@pytest.mark.parametrize("sparse", [False, True])
def test_scenario_sweep_on_a_mesh_matches_the_reference(j_mesh8, sparse):
    arrays, strategy = _arrays(2)
    if sparse:
        j_block = j_compile.compile_scenario(j_spec.from_dict(SPEC), B, N, sparse=True)
    else:
        rs = np.random.default_rng(3)
        kill = rs.random((8, B, N)) < 0.1
        j_block = j_compile.ScenarioBlock(
            kill=kill, revive=(rs.random((8, B, N)) < 0.1) & ~kill,
            set_faulty=np.where(rs.random((8, B, N)) < 0.2, rs.integers(0, 2, (8, B, N)),
                                -1).astype(np.int8),
            set_strategy=np.where(rs.random((8, B, N)) < 0.3, rs.integers(0, 5, (8, B, N)),
                                  -1).astype(np.int8))
    t_block = convert.block_from_numpy(j_block)
    kw = dict(depth=2, rounds_per_dispatch=3, collect_decisions=True)
    names = ("histograms", "decisions", "leaders", "counters_per_round")
    j_out = jp.scenario_sweep(jr.key(31), _jstate(arrays), j_block, engine="xla", mesh=j_mesh8,
                              initial_strategy=jnp.asarray(strategy), **kw)
    plain = tp.scenario_sweep(rng.key(31, CPU), _tstate(arrays), t_block, device="cpu",
                              initial_strategy=torch.tensor(strategy), **kw)
    for d in (8, 2):
        t_out = tp.scenario_sweep(rng.key(31, CPU), _tstate(arrays), t_block, mesh=_mesh(d),
                                  initial_strategy=torch.tensor(strategy), **kw)
        _same(j_out, t_out, names)
        _same(plain, t_out, names)
        assert j_out["counters"] == t_out["counters"] == plain["counters"]
        assert np.array_equal(np.asarray(t_out["final_strategy"]),
                              plain["final_strategy"].numpy())
        for name in ("leader", "faulty", "alive"):
            assert np.array_equal(np.asarray(getattr(t_out["final_state"], name)),
                                  getattr(plain["final_state"], name).numpy()), name
        assert t_out["stats"]["plane_peak_bytes_per_shard"] == \
            t_out["stats"]["plane_peak_bytes"] // d


def test_mesh_refusals_and_checks():
    arrays, _ = _arrays(4)
    mesh = _mesh(2)
    with pytest.raises(ValueError, match=r"signed=True is single-device \(mesh signed combos "
                                         r"are unsupported; shard by running independent "
                                         r"sweeps\)"):
        tp.pipeline_sweep(rng.key(0, CPU), _tstate(arrays), 2, signed=True, mesh=mesh)
    with pytest.raises(ValueError, match="engine='cuda' cannot run mesh data=2"):
        tp.pipeline_sweep(rng.key(0, CPU), _tstate(arrays), 2, engine="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="engine='cuda' cannot run mesh data=1"):
        tp.pipeline_sweep(rng.key(0, CPU), _tstate(arrays), 2, engine="cuda", mesh=_mesh(1))
    assert tp.engine_support(1, 2) is not None and tp.engine_support(1, 1, meshed=True)
    assert tp.engine_support(1) is None
    assert tp.resolve_engine(None, torch.device("cuda"), 1, n_shards=1, meshed=True) == "torch"
    with pytest.raises(ValueError, match="device=cuda"):
        tp.pipeline_sweep(rng.key(0, CPU), _tstate(arrays), 2, mesh=mesh, device="cuda")


def test_validate_mesh_messages_are_the_reference(eight_devices):
    for j_mesh, t_mesh, batch in (
            (j_make_mesh((8, 1), ("data", "node")), _mesh(8), 12),
            (j_make_mesh((8,), ("batch",)), make_mesh((8,), ("batch",), devices=[CPU] * 8),
             16)):
        with pytest.raises(ValueError) as j_err:
            j_shard.validate_mesh(j_mesh, batch)
        with pytest.raises(ValueError) as t_err:
            t_shard.validate_mesh(t_mesh, batch)
        assert str(t_err.value) == str(j_err.value)
    arrays, _ = _arrays(5)
    with pytest.raises(ValueError, match="not divisible"):
        tp.pipeline_sweep(rng.key(0, CPU), _tstate(arrays), 2,
                          mesh=make_mesh((3, 1), devices=[CPU] * 3))


def test_dispatch_trace_on_a_live_mesh():
    """Sharding adds no wait to the schedule: the depth-k trace of
    ``tests/test_torch_pipeline.py`` with counters on, a mesh of 4."""
    arrays, _ = _arrays(6)
    trace, work = [], []
    out = tp.pipeline_sweep(rng.key(0, CPU), _tstate(arrays), 10, depth=2,
                            rounds_per_dispatch=2, with_counters=True, mesh=_mesh(4),
                            on_event=lambda kind, d: trace.append((kind, d)),
                            host_work=work.append)
    assert trace == [("dispatch", 0), ("dispatch", 1), ("dispatch", 2), ("retire", 0),
                     ("dispatch", 3), ("retire", 1), ("dispatch", 4), ("retire", 2),
                     ("retire", 3), ("retire", 4)]
    assert work == [0, 1, 2, 3, 4] and out["stats"]["max_in_flight"] == 3


def _campaign(arrays):
    j_block = j_compile.compile_scenario(j_spec.from_dict(SPEC), B, N, sparse=True)
    return j_block, convert.block_from_numpy(j_block)


def test_checkpoints_cross_device_counts_and_packages(j_mesh8, tmp_path):
    arrays, _ = _arrays(7)
    j_block, t_block = _campaign(arrays)
    kw = dict(rounds_per_dispatch=2, collect_decisions=True)
    full = tp.scenario_sweep(rng.key(91, CPU), _tstate(arrays), t_block, device="cpu", **kw)
    ck = dict(checkpoint_every=4)
    tp.scenario_sweep(rng.key(91, CPU), _tstate(arrays), t_block, mesh=_mesh(8),
                      checkpoint_path=str(tmp_path / "port_{round}.npz"), **ck, **kw)
    jp.scenario_sweep(jr.key(91), _jstate(arrays), j_block, engine="xla", mesh=j_mesh8,
                      checkpoint_path=str(tmp_path / "ref_{round}.npz"), **ck, **kw)
    port_file, ref_file = str(tmp_path / "port_4.npz"), str(tmp_path / "ref_4.npz")
    assert validate_carry_checkpoint(port_file) == validate_carry_checkpoint(ref_file)
    assert tp.load_carry_checkpoint(port_file, CPU).shard_layout == {"data": 8, "node": 1}
    names = ("decisions", "leaders", "counters_per_round")

    def tail_ok(tail):
        for name in names:
            assert np.array_equal(np.asarray(tail[name]), full[name][4:]), name
        assert tail["counters"] == full["counters"]

    # the port's d = 8 file in the reference at d = 2 and d = 1
    for j_mesh in (j_make_mesh((2, 1), ("data", "node")), None):
        tail_ok(jp.scenario_sweep(None, None, j_block, engine="xla", resume=port_file,
                                  mesh=j_mesh, **kw))
    # the reference's d = 8 file in the port at d = 2 and d = 1
    for t_mesh in (_mesh(2), None):
        tail_ok(tp.scenario_sweep(None, None, t_block, resume=ref_file, mesh=t_mesh,
                                  device="cpu", **kw))


def test_live_per_shard_carry_resumes_anywhere(tmp_path):
    """A mesh run's live carry (Sharded state, ``[d, C]`` counters) resumes
    on another d and without a mesh, and saves as the canonical file."""
    arrays, _ = _arrays(8)
    _, t_block = _campaign(arrays)
    kw = dict(rounds_per_dispatch=2, collect_decisions=True)
    full = tp.scenario_sweep(rng.key(5, CPU), _tstate(arrays), t_block, device="cpu", **kw)
    tp.scenario_sweep(rng.key(5, CPU), _tstate(arrays), t_block, mesh=_mesh(8),
                      checkpoint_every=4, checkpoint_path=str(tmp_path / "h_{round}.npz"), **kw)
    ck = tp.load_carry_checkpoint(str(tmp_path / "h_4.npz"), CPU)
    mesh8 = _mesh(8)
    live = tp.CarryCheckpoint(state=M.shard_state(mesh8, ck.state), schedule=ck.schedule,
                              counters=t_shard.expand_counters(mesh8, ck.counters),
                              strategy=M.put_global(mesh8, ck.strategy, M.P("data")),
                              round=ck.round, shard_layout={"data": 8, "node": 1})
    tp.save_carry_checkpoint(str(tmp_path / "live.npz"), live)
    again = tp.load_carry_checkpoint(str(tmp_path / "live.npz"), CPU)
    assert torch.equal(again.counters, ck.counters)
    for mesh in (_mesh(4), None):
        tail = tp.scenario_sweep(None, None, t_block, resume=live, mesh=mesh, device="cpu", **kw)
        assert np.array_equal(tail["decisions"], full["decisions"][4:])
        assert tail["counters"] == full["counters"]
