"""Carry checkpoints across packages: files written by ``ba_tpu``'s
``pipeline_sweep`` (``engine="xla"``, one device or an 8-device CPU mesh)
resume in ``ba_tpu_torch`` bit-exactly, and the reverse; for the same
campaign and cursor both packages write equal arrays, dtypes, digests and
headers.  Also the port's snapshot helpers (the reference's own tests of
them, against the port's module), the sweep's checkpoint options and
their errors, and ``python -m ba_tpu_torch.scenario`` against
``python -m ba_tpu.scenario`` (that it loads no jax:
tests/test_torch_isolation.py).  B = 16, n = 8, R = 8; tolerance zero."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core.state import SimState as JState
from ba_tpu.parallel import make_sweep_state
from ba_tpu.parallel import pipeline as jp
from ba_tpu.scenario import compile as j_compile
from ba_tpu.scenario import spec as j_spec
from ba_tpu.utils import snapshot as j_snapshot
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.scenario import compile as t_compile
from ba_tpu_torch.scenario import spec as t_spec
from ba_tpu_torch.utils import snapshot

REPO = pathlib.Path(__file__).resolve().parent.parent
SPECS = sorted(str(p) for p in (REPO / "examples" / "scenarios").glob("*.json"))
B, N, R, RPD, EVERY = 16, 8, 8, 2, 4
# the campaign of tests/test_scenario.py's resume tests
DOC = {"name": "ckpt-campaign", "rounds": R, "order": "attack", "events": [
    {"round": 2, "kill": [1]},
    {"round": 5, "set_faulty": [3], "value": True},
    {"round": 6, "set_strategy": [3], "value": "adaptive_split"},
]}


def _state_arrays():
    state = make_sweep_state(jr.key(90), B, N, order=1)
    state = dataclasses.replace(state, faulty=state.faulty.at[:8, 0].set(True))
    return {name: np.asarray(getattr(state, name)) for name in snapshot.CARRY_STATE_FIELDS}


def _jstate(arrays):
    return JState(**{k: jnp.asarray(v).copy() for k, v in arrays.items()})


def _tstate(arrays):
    return convert.state_from_numpy(type("S", (), arrays), "cpu")


def _blocks(scenario):
    if not scenario:
        return None, None
    return (j_compile.compile_scenario(j_spec.from_dict(DOC), B, N, sparse=True),
            t_compile.compile_scenario(t_spec.from_dict(DOC), B, N, sparse=True))


def _kw(scenario):
    return dict(rounds_per_dispatch=RPD, collect_decisions=True,
                **({} if scenario else {"with_counters": True}))


OUTPUTS = ("histograms", "decisions", "counters_per_round")


def _same_tail(full, tail, start):
    for name in OUTPUTS + (("leaders",) if "leaders" in full else ()):
        assert np.array_equal(np.asarray(full[name])[start:], np.asarray(tail[name])), name
    assert full["counters"] == tail["counters"]
    for name in snapshot.CARRY_STATE_FIELDS:
        a, b = getattr(full["final_state"], name), getattr(tail["final_state"], name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    if "final_strategy" in full:
        assert np.array_equal(np.asarray(full["final_strategy"]),
                              np.asarray(tail["final_strategy"]))
    assert int(full["final_schedule"].counter) == int(tail["final_schedule"].counter) == R


@pytest.fixture(scope="module", params=["plain", "scenario"])
def campaign(request, tmp_path_factory):
    """The same campaign run by both packages, each writing a checkpoint
    every 4 rounds into its own ``{round}`` family."""
    scenario = request.param == "scenario"
    d = tmp_path_factory.mktemp(request.param)
    arrays = _state_arrays()
    j_block, t_block = _blocks(scenario)
    j_path, t_path = str(d / "j_{round}.npz"), str(d / "t_{round}.npz")
    j_out = jp.pipeline_sweep(jr.key(91), _jstate(arrays), R, scenario=j_block,
                              engine="xla", checkpoint_every=EVERY,
                              checkpoint_path=j_path, **_kw(scenario))
    t_out = tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(arrays), R,
                              scenario=t_block, device="cpu", checkpoint_every=EVERY,
                              checkpoint_path=t_path, **_kw(scenario))
    return dict(scenario=scenario, j_block=j_block, t_block=t_block, j_path=j_path,
                t_path=t_path, j_out=j_out, t_out=t_out, dir=d)


def test_uninterrupted_runs_agree(campaign):
    j_out, t_out = campaign["j_out"], campaign["t_out"]
    _same_tail(j_out, t_out, 0)
    assert t_out["stats"]["checkpoints"] == 2
    assert [w["round"] for w in t_out["stats"]["checkpoint_writes"]] == [4, 8]
    assert t_out["stats"]["run_id"] == j_out["stats"]["run_id"]


@pytest.mark.parametrize("cursor", [4, 8])
def test_same_file_in_both_packages(campaign, cursor):
    """Equal arrays, dtypes and shapes, equal digests and equal headers,
    key for key (the port writes ``traceparent: null``, as an untraced
    reference run does)."""
    j_meta, j_arrays = j_snapshot.read_carry_checkpoint(campaign["j_path"].format(round=cursor))
    t_meta, t_arrays = snapshot.read_carry_checkpoint(campaign["t_path"].format(round=cursor))
    assert t_meta == j_meta
    assert list(t_meta) == list(j_meta)
    assert t_meta["traceparent"] is None and t_meta["round"] == cursor
    assert t_meta["run_id"] == campaign["t_out"]["stats"]["run_id"]
    assert list(t_arrays) == list(j_arrays)
    for name, a in j_arrays.items():
        b = t_arrays[name]
        assert (b.dtype, b.shape) == (a.dtype, a.shape), name
        assert np.array_equal(a, b), name
    assert t_arrays["key_data"].dtype == np.uint32 and t_arrays["counter"].shape == ()
    assert snapshot.content_digest(t_arrays) == j_snapshot.content_digest(j_arrays)


def test_reference_checkpoint_resumes_in_port(campaign):
    path = campaign["j_path"].format(round=EVERY)
    tail = tp.pipeline_sweep(None, None, R, scenario=campaign["t_block"], resume=path,
                             device="cpu", **_kw(campaign["scenario"]))
    _same_tail(campaign["j_out"], tail, EVERY)
    assert tail["stats"]["start_round"] == EVERY and tail["stats"]["rounds"] == R - EVERY
    assert tail["stats"]["run_id"] == snapshot.validate_carry_checkpoint(path)["run_id"]


def test_port_checkpoint_resumes_in_reference(campaign):
    path = campaign["t_path"].format(round=EVERY)
    tail = jp.pipeline_sweep(None, None, R, scenario=campaign["j_block"], resume=path,
                             engine="xla", **_kw(campaign["scenario"]))
    _same_tail(campaign["j_out"], tail, EVERY)
    assert tail["stats"]["run_id"] == campaign["t_out"]["stats"]["run_id"]


def test_port_resumes_an_in_memory_checkpoint_twice(campaign):
    ck = tp.load_carry_checkpoint(campaign["t_path"].format(round=EVERY), "cpu")
    for _ in range(2):  # the checkpoint is copied, never consumed
        tail = tp.pipeline_sweep(None, None, R, scenario=campaign["t_block"], resume=ck,
                                 device="cpu", **_kw(campaign["scenario"]))
        _same_tail(campaign["t_out"], tail, EVERY)


def test_mesh_checkpoint_resumes_in_port_on_one_device(tmp_path):
    """The reference writes the scenario campaign on an 8-device CPU mesh
    in a subprocess (gather-on-write); the port resumes it on one device."""
    ck = tmp_path / "mesh_{round}.npz"
    child = f"""
import dataclasses, jax.random as jr
from ba_tpu.parallel import make_mesh, make_sweep_state, pipeline_sweep
from ba_tpu.scenario import compile_scenario, from_dict
state = make_sweep_state(jr.key(90), {B}, {N}, order=1)
state = dataclasses.replace(state, faulty=state.faulty.at[:8, 0].set(True))
block = compile_scenario(from_dict({DOC!r}), {B}, {N}, sparse=True)
out = pipeline_sweep(jr.key(91), state, {R}, scenario=block, rounds_per_dispatch={RPD},
                     mesh=make_mesh((8, 1), ("data", "node")), checkpoint_every={EVERY},
                     checkpoint_path={str(ck)!r}, engine="xla")
assert out["stats"]["shards"] == 8
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = str(ck).format(round=EVERY)
    meta = snapshot.validate_carry_checkpoint(path)
    assert meta["shard_layout"] == {"data": 8, "node": 1}
    _, t_block = _blocks(True)
    full = tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(_state_arrays()), R,
                             scenario=t_block, device="cpu", **_kw(True))
    tail = tp.pipeline_sweep(None, None, R, scenario=t_block, resume=path, device="cpu",
                             **_kw(True))
    _same_tail(full, tail, EVERY)
    assert tail["stats"]["run_id"] == meta["run_id"]


@pytest.mark.parametrize("depth,rpd", [(1, 1), (3, 1), (2, 3)])
def test_every_checkpoint_holds_its_boundary_carry(tmp_path, depth, rpd):
    """The carry is reused in place and a dispatch retires ``depth``
    dispatches later: each file must still hold the carry of its own
    boundary (cursor == stored counter, and the tail resumes)."""
    _, t_block = _blocks(True)
    path = str(tmp_path / "b_{round}.npz")
    full = tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(_state_arrays()), R,
                             scenario=t_block, device="cpu", depth=depth,
                             rounds_per_dispatch=rpd, collect_decisions=True,
                             checkpoint_every=1, checkpoint_path=path)
    cursors = [r for r, _ in snapshot.checkpoint_paths(path)]
    assert cursors == sorted({min(R, -(-r // rpd) * rpd) for r in range(1, R + 1)})
    for r, p in snapshot.checkpoint_paths(path)[:-1]:
        tail = tp.pipeline_sweep(None, None, R, scenario=t_block, resume=p, device="cpu",
                                 rounds_per_dispatch=rpd, collect_decisions=True)
        _same_tail(full, tail, r)


def test_checkpoint_alignment_rows_hook_and_retention(tmp_path):
    """Checkpoints align up to dispatch boundaries (every 3 at 2 a
    dispatch: rounds 4 and 8); ``on_rows`` sees a window before the same
    retire's ``on_checkpoint``; keep_last prunes the family; meta rides
    the header."""
    calls = []
    path = str(tmp_path / "a_{round}.npz")
    out = tp.pipeline_sweep(
        rng.key(3, device="cpu"), _tstate(_state_arrays()), R, rounds_per_dispatch=RPD,
        with_counters=True, device="cpu", checkpoint_every=3, checkpoint_path=path,
        checkpoint_keep_last=1, checkpoint_meta={"campaign": "t"},
        on_rows=lambda d, lo, hi, ys: calls.append(("rows", lo, hi, len(ys))),
        on_checkpoint=lambda r, p: calls.append(("ckpt", r, os.path.basename(p))),
    )
    assert calls == [("rows", 0, 2, 2), ("rows", 2, 4, 2), ("ckpt", 4, "a_4.npz"),
                     ("rows", 4, 6, 2), ("rows", 6, 8, 2), ("ckpt", 8, "a_8.npz")]
    assert [r for r, _ in snapshot.checkpoint_paths(path)] == [8]
    meta = snapshot.validate_carry_checkpoint(path.format(round=8))
    assert meta["campaign"] == "t" and meta["rounds_total"] == R
    assert meta["counter_names"] == list(tp.COUNTER_NAMES) and meta["scenario"] is False
    assert out["stats"]["checkpoints"] == 2


def test_run_id_keyword_and_derivation(tmp_path):
    arrays = _state_arrays()
    path = str(tmp_path / "r_{round}.npz")
    out = tp.pipeline_sweep(rng.key(5, device="cpu"), _tstate(arrays), 4, device="cpu",
                            checkpoint_every=2, checkpoint_path=path, run_id="drill-7")
    assert out["stats"]["run_id"] == "drill-7"
    assert snapshot.validate_carry_checkpoint(path.format(round=2))["run_id"] == "drill-7"
    tail = tp.pipeline_sweep(None, None, 4, resume=path.format(round=2), device="cpu")
    assert tail["stats"]["run_id"] == "drill-7"  # the header's id is inherited
    with pytest.raises(ValueError, match="run id"):
        tp.pipeline_sweep(rng.key(5, device="cpu"), _tstate(arrays), 4, device="cpu",
                          run_id="bad id!")
    j_out = jp.pipeline_sweep(jr.key(5), _jstate(arrays), 4, engine="xla")
    t_out = tp.pipeline_sweep(rng.key(5, device="cpu"), _tstate(arrays), 4, device="cpu")
    assert t_out["stats"]["run_id"] == j_out["stats"]["run_id"]  # the derived id


def test_resume_validation_errors(tmp_path):
    """tests/test_scenario.py's resume validation, against the port."""
    _, t_block = _blocks(True)
    arrays = _state_arrays()
    path = str(tmp_path / "ck_{round}.npz")
    tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(arrays), R, scenario=t_block,
                      rounds_per_dispatch=RPD, device="cpu", checkpoint_every=EVERY,
                      checkpoint_path=path)
    ck = tp.load_carry_checkpoint(path.format(round=EVERY), "cpu")
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="key=None"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), R, scenario=t_block,
                          resume=ck, **cpu)
    with pytest.raises(ValueError, match="initial_strategy"):
        tp.pipeline_sweep(None, None, R, scenario=t_block, resume=ck,
                          initial_strategy=torch.zeros((B, N), dtype=torch.int8), **cpu)
    short = t_compile.compile_scenario(
        t_spec.from_dict({"name": "short", "rounds": ck.round, "events": []}), B, N,
        sparse=True)
    with pytest.raises(ValueError, match="outside campaign"):
        tp.pipeline_sweep(None, None, ck.round, scenario=short, resume=ck, **cpu)
    with pytest.raises(ValueError, match="strategy plane"):
        tp.pipeline_sweep(None, None, R, resume=ck, **cpu)  # scenario carry, no block
    plain = tp.load_carry_checkpoint(path.format(round=EVERY), "cpu")
    plain = dataclasses.replace(plain, strategy=None)
    with pytest.raises(ValueError, match="strategy/counter"):
        tp.pipeline_sweep(None, None, R, scenario=t_block, resume=plain, **cpu)
    with pytest.raises(ValueError, match="with_counters=True"):
        tp.pipeline_sweep(None, None, R, resume=plain, **cpu)
    no_counters = dataclasses.replace(plain, counters=None)
    with pytest.raises(ValueError, match="with_counters=False"):
        tp.pipeline_sweep(None, None, R, resume=no_counters, with_counters=True, **cpu)
    with pytest.raises(ValueError, match="pass key and state"):
        tp.pipeline_sweep(None, None, R, **cpu)
    with pytest.raises(ValueError, match="checkpoint_every"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), R,
                          checkpoint_path=str(tmp_path / "x.npz"), **cpu)
    with pytest.raises(ValueError, match="checkpoint_every"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), R,
                          checkpoint_every=0, **cpu)
    with pytest.raises(ValueError, match="checkpoint_path"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), R,
                          checkpoint_every=2, **cpu)
    with pytest.raises(ValueError, match="reserved"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), R,
                          checkpoint_every=2, checkpoint_path=path,
                          checkpoint_meta={"round": 3}, **cpu)
    with pytest.raises(ValueError, match="checkpoint_every"):
        tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), R,
                          checkpoint_meta={"campaign": "x"}, **cpu)


def test_signed_carries_raise(tmp_path):
    """A signed carry is written with the signed counter table and refuses
    to resume an oral sweep; a signed file in the reference's header form
    loads and refuses the same way, and is rewritten unchanged."""
    arrays = _state_arrays()
    signed_ck = str(tmp_path / "s_{round}.npz")
    tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), R, signed=True,
                      rounds_per_dispatch=2, checkpoint_every=4, checkpoint_path=signed_ck,
                      device="cpu", pool=0)
    meta = snapshot.validate_carry_checkpoint(signed_ck.format(round=4))
    assert meta["signed"] and meta["counter_names"] == list(tp.SIGNED_COUNTER_NAMES)
    with pytest.raises(ValueError, match="crosses protocols"):
        tp.pipeline_sweep(None, None, R, resume=signed_ck.format(round=4), with_counters=True,
                          rounds_per_dispatch=2, device="cpu")
    path = str(tmp_path / "p_{round}.npz")
    tp.pipeline_sweep(rng.key(0, device="cpu"), _tstate(arrays), 4, with_counters=True,
                      device="cpu", checkpoint_every=2, checkpoint_path=path)
    meta, host = snapshot.read_carry_checkpoint(path.format(round=2))
    host["counters"] = np.zeros(5, np.int32)
    signed_path = str(tmp_path / "signed.npz")
    snapshot.write_carry_checkpoint(signed_path, host, dict(
        meta, signed=True, counter_names=list(tp.SIGNED_COUNTER_NAMES)))
    ck = tp.load_carry_checkpoint(signed_path, "cpu")
    assert ck.signed
    with pytest.raises(ValueError, match="crosses protocols"):
        tp.pipeline_sweep(None, None, 4, resume=signed_path, with_counters=True,
                          device="cpu")
    with pytest.raises(ValueError, match="crosses protocols"):
        tp.pipeline_sweep(None, None, 4, resume=path.format(round=2), signed=True,
                          device="cpu", pool=0)
    tp.save_carry_checkpoint(str(tmp_path / "w.npz"), ck)
    assert snapshot.read_carry_checkpoint(str(tmp_path / "w.npz"))[0]["signed"]
    # a block whose stored names differ from the table the header picks
    snapshot.write_carry_checkpoint(signed_path, host, dict(
        meta, counter_names=list(tp.SIGNED_COUNTER_NAMES)))
    with pytest.raises(ValueError, match="positionally"):
        tp.load_carry_checkpoint(signed_path, "cpu")


def test_save_gathers_a_per_device_counter_block(tmp_path):
    """A ``[d, C]`` block sums to the canonical one on write (the layout
    defaults to ``{"data": d}``); resumed in memory it sums too."""
    _, t_block = _blocks(True)
    path = str(tmp_path / "g_{round}.npz")
    full = tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(_state_arrays()), R,
                             scenario=t_block, device="cpu", checkpoint_every=EVERY,
                             checkpoint_path=path, **_kw(True))
    ck = tp.load_carry_checkpoint(path.format(round=EVERY), "cpu")
    per_device = torch.zeros((4, 5), dtype=torch.int32)
    per_device[0] = ck.counters - 3
    per_device[3] = 3
    split = dataclasses.replace(ck, counters=per_device, shard_layout=None)
    out = str(tmp_path / "split.npz")
    nbytes = tp.save_carry_checkpoint(out, split)
    meta, arrays = snapshot.read_carry_checkpoint(out)
    assert meta["shard_layout"] == {"data": 4}
    assert np.array_equal(arrays["counters"], ck.counters.numpy())
    assert nbytes == sum(a.nbytes for a in arrays.values())
    for resume in (out, split):
        tail = tp.pipeline_sweep(None, None, R, scenario=t_block, resume=resume,
                                 device="cpu", **_kw(True))
        _same_tail(full, tail, EVERY)


def test_sim_state_file_round_trip(tmp_path):
    state = _tstate(_state_arrays())
    path = str(tmp_path / "state.npz")
    snapshot.save_sim_state(path, state, extra=np.arange(3))
    back, extra = snapshot.load_sim_state(path, "cpu")
    for a, b in zip(state.tensors(), back.tensors()):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert list(extra) == ["extra"] and extra["extra"].tolist() == [0, 1, 2]


# -- the snapshot helpers: the reference's own tests, on the port's module --


def _corrupt(path, mode):
    """``ba_tpu.runtime.chaos.corrupt_file``: ``flip`` inverts 64 bytes at
    the middle of the file, ``truncate`` keeps the first half."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        if mode == "truncate":
            fh.truncate(max(1, size // 2))
            return
        fh.seek(size // 2)
        chunk = fh.read(min(64, max(1, size - size // 2)))
        fh.seek(size // 2)
        fh.write(bytes(b ^ 0xFF for b in chunk))


def _port_checkpoints(template, every=4, rounds=R):
    _, t_block = _blocks(True)
    events = [e for e in DOC["events"] if e["round"] < rounds]
    block = t_block if rounds == R else t_compile.compile_scenario(
        t_spec.from_dict(dict(DOC, rounds=rounds, events=events)), B, N, sparse=True)
    return tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(_state_arrays()), rounds,
                             scenario=block, rounds_per_dispatch=RPD, device="cpu",
                             checkpoint_every=every, checkpoint_path=str(template))


def test_checkpoint_schema_rejects_corruption(tmp_path):
    path = str(tmp_path / "ck.npz")
    _port_checkpoints(path, every=3, rounds=6)
    meta, arrays = snapshot.read_carry_checkpoint(path)
    assert meta["scenario"] is True and meta["rounds_total"] == 6
    bad = str(tmp_path / "bad.npz")
    snapshot.write_carry_checkpoint(bad, arrays, dict(meta, round=meta["round"] + 1))
    with pytest.raises(ValueError, match="disagrees"):
        snapshot.read_carry_checkpoint(bad)
    broken = {k: v for k, v in arrays.items() if k != "key_data"}
    snapshot.write_carry_checkpoint(bad, broken, meta)
    with pytest.raises(ValueError, match="missing carry arrays"):
        snapshot.read_carry_checkpoint(bad)
    no_strat = {k: v for k, v in arrays.items() if k != "strategy"}
    snapshot.write_carry_checkpoint(bad, no_strat, meta)
    with pytest.raises(ValueError, match="without counters/strategy"):
        snapshot.read_carry_checkpoint(bad)
    with open(path, "rb") as fh:
        head = fh.read(40)
    with open(bad, "wb") as fh:
        fh.write(head)
    with pytest.raises(ValueError, match="not a readable"):
        snapshot.read_carry_checkpoint(bad)
    assert meta["shard_layout"] == {"data": 1}
    for layout in ({"data": 0}, "8x1"):
        snapshot.write_carry_checkpoint(bad, arrays, dict(meta, shard_layout=layout))
        with pytest.raises(ValueError, match="shard_layout"):
            snapshot.read_carry_checkpoint(bad)
    snapshot.write_carry_checkpoint(bad, arrays, dict(meta, v=2))
    with pytest.raises(ValueError, match="version"):
        snapshot.read_carry_checkpoint(bad)
    snapshot.write_carry_checkpoint(bad, dict(arrays, counters=np.zeros(3, np.int32)), meta)
    with pytest.raises(ValueError, match="counter_names"):
        snapshot.read_carry_checkpoint(bad)
    with pytest.raises(ValueError, match="reserved"):
        tp.save_carry_checkpoint(bad, tp.load_carry_checkpoint(path, "cpu"), sha256="x")


def test_content_digest_rejects_silent_flip(tmp_path):
    _port_checkpoints(tmp_path / "ck_{round}.npz")
    ck = str(tmp_path / "ck_4.npz")
    meta = snapshot.validate_carry_checkpoint(ck)
    assert len(meta["sha256"]) == 64
    _corrupt(ck, "flip")
    with pytest.raises(ValueError, match="digest|corrupt|bad|invalid"):
        snapshot.read_carry_checkpoint(ck)


def test_checkpoint_family_scan_ignores_strays(tmp_path):
    tmpl = str(tmp_path / "ck_{round}.npz")
    for r in (2, 4, 10):
        (tmp_path / f"ck_{r}.npz").write_bytes(b"x")
    (tmp_path / "ck_4.npz.tmp.123").write_bytes(b"x")
    (tmp_path / "ck_2.npz.corrupt").write_bytes(b"x")
    (tmp_path / "ck_nope.npz").write_bytes(b"x")
    assert snapshot.checkpoint_paths(tmpl) == [
        (2, str(tmp_path / "ck_2.npz")), (4, str(tmp_path / "ck_4.npz")),
        (10, str(tmp_path / "ck_10.npz"))]
    with pytest.raises(ValueError):
        snapshot.checkpoint_paths(str(tmp_path / "ck.npz"))
    with pytest.raises(ValueError):
        snapshot.checkpoint_paths(str(tmp_path / "{round}" / "ck.npz"))


def test_prune_keep_last_removes_sidecars_too(tmp_path):
    tmpl = str(tmp_path / "ck_{round}.npz")
    for r in (2, 4, 6, 8):
        (tmp_path / f"ck_{r}.npz").write_bytes(b"x")
        (tmp_path / f"ck_{r}.npz.rows.npz").write_bytes(b"y")
    removed = snapshot.prune_checkpoints(tmpl, keep_last=2)
    assert sorted(removed) == [str(tmp_path / "ck_2.npz"), str(tmp_path / "ck_4.npz")]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ck_6.npz", "ck_6.npz.rows.npz", "ck_8.npz", "ck_8.npz.rows.npz"]
    with pytest.raises(ValueError):
        snapshot.prune_checkpoints(tmpl, keep_last=0)


def test_engine_checkpoint_keep_last_retention(tmp_path):
    path = str(tmp_path / "ck_{round}.npz")
    _, t_block = _blocks(True)
    out = tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(_state_arrays()), R,
                            scenario=t_block, rounds_per_dispatch=RPD, device="cpu",
                            checkpoint_every=2, checkpoint_path=path, checkpoint_keep_last=2)
    assert out["stats"]["checkpoints"] == 4
    assert [r for r, _ in snapshot.checkpoint_paths(path)] == [6, 8]
    key = rng.key(0, device="cpu")
    with pytest.raises(ValueError):
        tp.pipeline_sweep(key, None, R, checkpoint_keep_last=2, checkpoint_every=2,
                          checkpoint_path=str(tmp_path / "flat.npz"), device="cpu")
    with pytest.raises(ValueError):
        tp.pipeline_sweep(key, None, R, checkpoint_keep_last=2, device="cpu")
    with pytest.raises(ValueError):
        tp.pipeline_sweep(key, None, R, checkpoint_keep_last=2, checkpoint_every=2,
                          checkpoint_path=str(tmp_path / "{round}" / "c.npz"), device="cpu")


def test_newest_valid_checkpoint_quarantines_and_falls_back(tmp_path):
    path = tmp_path / "ck_{round}.npz"
    _port_checkpoints(path)  # ck_4 and ck_8
    _corrupt(str(tmp_path / "ck_8.npz"), "truncate")
    found = snapshot.newest_valid_checkpoint(str(path))
    assert found is not None
    got_path, meta = found
    assert got_path == str(tmp_path / "ck_4.npz") and meta["round"] == 4
    assert not (tmp_path / "ck_8.npz").exists()
    assert (tmp_path / "ck_8.npz.corrupt").exists()
    _corrupt(str(tmp_path / "ck_4.npz"), "flip")
    assert snapshot.newest_valid_checkpoint(str(path)) is None


def test_newest_valid_checkpoint_below_cut_and_accept(tmp_path):
    path = tmp_path / "cut_{round}.npz"
    _port_checkpoints(path)  # cut_4 and cut_8
    found = snapshot.newest_valid_checkpoint(str(path), below=8)
    assert found is not None and found[1]["round"] == 4
    assert snapshot.newest_valid_checkpoint(str(path), below=4) is None
    assert snapshot.newest_valid_checkpoint(
        str(path), accept=lambda meta: meta["round"] == 4)[1]["round"] == 4
    assert (tmp_path / "cut_4.npz").exists() and (tmp_path / "cut_8.npz").exists()
    plain = str(tmp_path / "cut_8.npz")
    assert snapshot.newest_valid_checkpoint(plain)[0] == plain
    assert snapshot.quarantine_checkpoint(plain) == plain + ".corrupt"
    assert snapshot.newest_valid_checkpoint(plain) is None


# -- the validator CLI ---------------------------------------------------------


def _cli(package, *paths):
    proc = subprocess.run([sys.executable, "-m", f"{package}.scenario", *paths],
                          capture_output=True, text=True, cwd=str(REPO), timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return proc.returncode, proc.stdout, proc.stderr


def test_cli_matches_the_reference(campaign):
    """Byte-identical stdout and the same exit codes on the committed
    specs, on a checkpoint from each package, on a corrupted one, and
    without arguments."""
    bad = str(campaign["dir"] / "bad.npz")
    with open(campaign["t_path"].format(round=EVERY), "rb") as fh:
        data = fh.read()
    with open(bad, "wb") as fh:
        fh.write(data[: len(data) // 2])
    cases = [SPECS, [campaign["j_path"].format(round=EVERY), campaign["t_path"].format(
        round=R)], [campaign["t_path"].format(round=EVERY), bad], []]
    for paths in cases:
        j_rc, j_out, _ = _cli("ba_tpu", *paths)
        t_rc, t_out, t_err = _cli("ba_tpu_torch", *paths)
        assert (t_rc, t_out) == (j_rc, j_out), t_err
    assert len(SPECS) >= 2 and t_rc == 2 and "ba_tpu_torch.scenario" in t_err

