"""The port's supervised campaigns (``ba_tpu_torch/runtime/supervisor.py``
and ``pipeline_sweep``'s resilience seams) against the JAX package's
``supervised_sweep`` on the CPU, tolerance zero.

The campaign is ``tests/test_supervisor.py``'s: B = 16, n = 8, R = 12, a
churny scenario (a kill, a fault flip, a strategy, a revive), two rounds a
dispatch; the reference runs ``engine="xla"``.  Each supervised run, clean
or under a fault plan, is bit-identical to the reference's supervised run
on the same inputs and to the reference's uninterrupted run: decisions,
leaders, histograms, every counter block, the final state and the
``supervisor`` block (run id included) but its ``timeout_s``.  Checkpoint
families cross the packages both ways after a real ``SIGKILL``, with the
same ``campaign_sha256`` and sidecars each package reads."""

import collections
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ba_tpu.core.state import SimState as JState
from ba_tpu.parallel import make_sweep_state
from ba_tpu.parallel import pipeline as jp
from ba_tpu.runtime import chaos as j_chaos
from ba_tpu.runtime import supervisor as j_sup
from ba_tpu.scenario import compile as j_compile
from ba_tpu.scenario import spec as j_spec
from ba_tpu.utils import metrics as j_metrics
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.parallel import pipeline as tp
from ba_tpu_torch.parallel.mesh import make_mesh
from ba_tpu_torch.runtime import chaos, supervisor
from ba_tpu_torch.scenario import compile as t_compile
from ba_tpu_torch.scenario import spec as t_spec
from ba_tpu_torch.utils import metrics as t_metrics
from ba_tpu_torch.utils import snapshot

REPO = pathlib.Path(__file__).resolve().parent.parent
B, N, R, RPD, EVERY = 16, 8, 12, 2, 4
DOC = {"name": "supervised-campaign", "rounds": R, "order": "attack", "events": [
    {"round": 2, "kill": [1]},
    {"round": 5, "set_faulty": [3], "value": True},
    {"round": 6, "set_strategy": [3], "value": "adaptive_split"},
    {"round": 9, "revive": [1]},
]}
NAMES = ["histograms", "leaders", "counter_rows", "decisions"]
OUTPUTS = ("decisions", "leaders", "counters_per_round", "histograms")


def _arrays():
    state = make_sweep_state(jr.key(90), B, N, order=1)
    state = dataclasses.replace(state, faulty=state.faulty.at[: B // 2, 0].set(True))
    return {name: np.asarray(getattr(state, name)) for name in snapshot.CARRY_STATE_FIELDS}


ARRAYS = _arrays()
J_BLOCK = j_compile.compile_scenario(j_spec.from_dict(DOC), B, N, sparse=True)
T_BLOCK = t_compile.compile_scenario(t_spec.from_dict(DOC), B, N, sparse=True)


def _jstate():
    return JState(**{k: jnp.asarray(v).copy() for k, v in ARRAYS.items()})


def _tstate():
    return convert.state_from_numpy(type("S", (), ARRAYS), "cpu")


def _ref(plan=None, cfg=None, **kw):
    """The reference's supervised campaign."""
    return j_sup.supervised_sweep(
        jr.key(91), _jstate(), scenario=J_BLOCK, rounds_per_dispatch=RPD,
        collect_decisions=True, engine="xla",
        chaos=None if plan is None else j_chaos.from_dict(plan),
        config=j_sup.SupervisorConfig(**{"timeout_s": 60.0, **(cfg or {})}), **kw)


def _port(plan=None, cfg=None, **kw):
    """The port's supervised campaign, on the CPU."""
    return supervisor.supervised_sweep(
        rng.key(91, device="cpu"), _tstate(), scenario=T_BLOCK, rounds_per_dispatch=RPD,
        collect_decisions=True, device="cpu",
        chaos=None if plan is None else chaos.from_dict(plan),
        config=supervisor.SupervisorConfig(**{"timeout_s": 60.0, **(cfg or {})}), **kw)


@pytest.fixture(scope="module")
def baseline():
    """The reference's uninterrupted, unsupervised campaign."""
    return jp.pipeline_sweep(jr.key(91), _jstate(), R, scenario=J_BLOCK,
                             rounds_per_dispatch=RPD, collect_decisions=True, engine="xla")


def _same(got, want):
    for name in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), name)
    assert got["counters"] == want["counters"]
    for name in snapshot.CARRY_STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got["final_state"], name)),
                                      np.asarray(getattr(want["final_state"], name)), name)


def _same_supervisor(got, want):
    a, b = dict(got["supervisor"]), dict(want["supervisor"])
    a.pop("timeout_s"), b.pop("timeout_s")
    assert a == b


CASES = {
    "clean": (None, {}, False),
    "transient_storm": ({"name": "storm", "faults": [
        {"round": 2, "kind": "transient"},
        {"round": 6, "kind": "transient", "phase": "retire", "times": 2},
        {"round": 8, "kind": "stall", "phase": "retire", "seconds": 0.2},
    ]}, {"timeout_s": 0.05, "backoff_base_s": 0.01}, False),
    "fatal": ({"name": "fatal", "faults": [{"round": 8, "kind": "fatal"}]}, {}, True),
    "corrupt_fallback": ({"name": "rot", "faults": [
        {"round": 4, "kind": "corrupt", "mode": "flip"},
        {"round": 8, "kind": "fatal"},
    ]}, {}, True),
    "oom_degrade": ({"name": "oom", "faults": [{"round": 6, "kind": "oom"}]},
                    {"backoff_base_s": 0.01}, True),
}
EXPECT = {
    "clean": dict(attempts=1, retries=0, recoveries=0, stalls=0, injected=0),
    "transient_storm": dict(attempts=1, retries=3, stalls=1, injected=4),
    "fatal": dict(attempts=2, recoveries=1),
    "corrupt_fallback": dict(attempts=2, recoveries=1),
    "oom_degrade": dict(degrades=1, depth=1, recoveries=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervised_campaign_matches_the_reference(case, baseline, tmp_path):
    plan, cfg, ckpt = CASES[case]
    kw = {}
    if ckpt:
        kw = dict(checkpoint_every=EVERY, depth=2)
    got = _port(plan, cfg, **kw, **({"checkpoint_path": str(tmp_path / "t_{round}.npz")}
                                    if ckpt else {}))
    want = _ref(plan, cfg, **kw, **({"checkpoint_path": str(tmp_path / "j_{round}.npz")}
                                    if ckpt else {}))
    _same(got, baseline)
    _same(want, baseline)
    _same_supervisor(got, want)
    for key, value in EXPECT[case].items():
        assert got["supervisor"][key] == value, key
    assert got["supervisor"]["history_rounds"] == R
    if ckpt:
        assert got["stats"]["checkpoints"] == want["stats"]["checkpoints"]
    if case == "fatal":  # every write of the family was this one call's
        assert got["stats"]["checkpoints"] == len(
            snapshot.checkpoint_paths(str(tmp_path / "t_{round}.npz")))
    if case == "corrupt_fallback":
        assert (tmp_path / "t_4.npz.corrupt").exists()
        snapshot.validate_carry_checkpoint(str(tmp_path / "t_4.npz"))


def test_poison_window_quarantines_like_the_reference(tmp_path):
    plan = {"name": "poison", "faults": [{"round": 6, "kind": "fatal", "times": -1}]}
    cfg = {"poison_threshold": 3, "backoff_base_s": 0.01}
    reps = {}
    for tag, run, poison in (("t", _port, supervisor.PoisonousWindow),
                             ("j", _ref, j_sup.PoisonousWindow)):
        d = tmp_path / tag
        d.mkdir()
        with pytest.raises(poison) as exc:
            run(plan, cfg, checkpoint_every=2, checkpoint_path=str(d / "p_{round}.npz"))
        rep = dict(exc.value.reproducer)
        assert rep.pop("resume") == str(d / "p_2.npz")
        assert rep.pop("reproducer_path") == str(d / "poison_2.json")
        assert json.loads((d / "poison_2.json").read_text())["window"] == [2, 4]
        reps[tag] = rep
    assert reps["t"] == reps["j"]
    assert reps["t"]["window"] == [2, 4] and reps["t"]["failures"] == 3
    assert isinstance(exc.value, j_sup.SupervisorError)


def test_stall_watchdog_fires_at_the_same_dispatch():
    """A 0.2 s stall in the retire of rounds [2, 4) against a 0.05 s
    watchdog: one stall, at dispatch 1, in both packages."""
    doc = {"name": "stall", "faults": [
        {"round": 2, "kind": "stall", "phase": "retire", "seconds": 0.2}]}
    seen = {}
    for tag in ("t", "j"):
        stalls = []
        inj = (chaos if tag == "t" else j_chaos).ChaosInjector(
            (chaos if tag == "t" else j_chaos).from_dict(doc))
        kw = dict(scenario=T_BLOCK if tag == "t" else J_BLOCK, rounds_per_dispatch=RPD,
                  exec_seam=lambda call, phase, d, lo, hi, inj=inj: inj.fire(call, phase, lo, hi),
                  retire_timeout_s=0.05, on_stall=lambda d, t, s=stalls: s.append((d, t)))
        if tag == "t":
            out = tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(), R, device="cpu", **kw)
        else:
            out = jp.pipeline_sweep(jr.key(91), _jstate(), R, engine="xla", **kw)
        seen[tag] = (stalls, out["stats"]["stalls"], [f["kind"] for f in inj.fired])
    assert seen["t"] == seen["j"] == ([(1, 0.05)], 1, ["stall"])


def test_the_watchdog_rearms_after_a_stall():
    """Stalls in the retires of rounds [2, 4) and [6, 8) against a 0.05 s
    watchdog: two stalls, at dispatches 1 and 3, in both packages."""
    doc = {"name": "two-stalls", "faults": [
        {"round": r, "kind": "stall", "phase": "retire", "seconds": 0.2} for r in (2, 6)]}
    seen = {}
    for tag, mod in (("t", chaos), ("j", j_chaos)):
        stalls = []
        inj = mod.ChaosInjector(mod.from_dict(doc))
        kw = dict(scenario=T_BLOCK if tag == "t" else J_BLOCK, rounds_per_dispatch=RPD,
                  exec_seam=lambda call, phase, d, lo, hi, inj=inj: inj.fire(call, phase, lo, hi),
                  retire_timeout_s=0.05, on_stall=lambda d, t, s=stalls: s.append((d, t)))
        if tag == "t":
            out = tp.pipeline_sweep(rng.key(91, device="cpu"), _tstate(), R, device="cpu", **kw)
        else:
            out = jp.pipeline_sweep(jr.key(91), _jstate(), R, engine="xla", **kw)
        seen[tag] = (stalls, out["stats"]["stalls"])
    assert seen["t"] == seen["j"] == ([(1, 0.05), (3, 0.05)], 2)


def test_the_watchdog_is_one_thread_a_sweep():
    """The retire watchdog is one thread for the whole sweep, not one a
    retire: the same one extra thread is alive at every retire, and none
    is left when the sweep returns."""
    before = set(threading.enumerate())
    seen = []

    def seam(call, phase, d, lo, hi):
        if phase == "retire":
            seen.append(frozenset(threading.enumerate()) - before)
        return call()

    out = tp.pipeline_sweep(rng.key(5, device="cpu"), _tstate(), R, rounds_per_dispatch=1,
                            device="cpu", exec_seam=seam, retire_timeout_s=60.0)
    assert len(seen) == R and len(set(seen)) == 1 and len(seen[0]) == 1
    assert set(threading.enumerate()) - before == set()
    assert out["stats"]["stalls"] == 0


def test_seam_options_are_checked_before_any_work():
    key, state = rng.key(1, device="cpu"), _tstate()
    for kw in ({"on_stall": lambda d, t: None}, {"retire_timeout_s": 0.0},
               {"retire_timeout_s": -1.0}, {"health_every": 0}):
        with pytest.raises(ValueError):
            tp.pipeline_sweep(key, state, R, device="cpu", **kw)  # ba-lint: disable=BA201 (each call raises first)
    with pytest.raises(ValueError, match="owned by the supervisor"):
        supervisor.supervised_sweep(key, None, R, exec_seam=lambda *a: None)
    with pytest.raises(ValueError, match="rounds"):
        supervisor.supervised_sweep(key, None)
    with pytest.raises(ValueError, match="directory component"):
        _port(checkpoint_every=2, checkpoint_keep_last=2,
              checkpoint_path=str(pathlib.Path("d_{round}") / "carry.npz"))


def test_mesh_recovery_is_bit_exact(baseline, tmp_path):
    """A fatal fault on a two-entry mesh of CPU entries recovers from its
    gathered checkpoint, split again on read, bit-identical to the
    reference's single-device run."""
    plan = {"name": "mesh-fatal", "faults": [{"round": 8, "kind": "fatal"}]}
    got = _port(plan, mesh=make_mesh((2, 1), ("data", "node"), devices=["cpu"] * 2),
                checkpoint_every=EVERY, checkpoint_path=str(tmp_path / "m_{round}.npz"))
    _same(got, baseline)
    assert got["supervisor"]["attempts"] == 2 and got["supervisor"]["recoveries"] == 1
    assert got["stats"]["shards"] == 2


class _RunsThenRaises:
    """An injector whose fault lets the real dispatch call run and then
    raises a transient-marked error, once, at the dispatch of round 6."""

    def __init__(self):
        self.fired = []

    def fire(self, call, phase, lo, hi):
        out = call()
        if phase == "dispatch" and lo <= 6 < hi and not self.fired:
            self.fired.append({"kind": "transient", "phase": phase, "window": [lo, hi]})
            raise chaos.InjectedTransient("raised after the real call ran")
        return out

    def after_checkpoint(self, round_cursor, path):
        pass


def test_a_dispatch_retried_after_its_call_began_recovers(baseline, tmp_path):
    """The retry in place meets the consumed carry and refuses it
    (``CarryConsumed``, fatal); the campaign recovers from the round-4
    checkpoint and stays bit-exact."""
    inj = _RunsThenRaises()
    got = supervisor.supervised_sweep(
        rng.key(91, device="cpu"), _tstate(), scenario=T_BLOCK, rounds_per_dispatch=RPD,
        collect_decisions=True, device="cpu", chaos=inj,
        config=supervisor.SupervisorConfig(timeout_s=60.0, backoff_base_s=0.01),
        checkpoint_every=EVERY, checkpoint_path=str(tmp_path / "g_{round}.npz"))
    _same(got, baseline)
    sup = got["supervisor"]
    assert (sup["retries"], sup["recoveries"], sup["attempts"]) == (1, 1, 2)
    with pytest.raises(tp.CarryConsumed):
        once = tp._runs_once(lambda: None)
        once()
        once()
    assert supervisor.classify_fault(tp.CarryConsumed("x")) == supervisor.FATAL


def test_supervision_adds_no_wait_and_no_dispatch(monkeypatch, tmp_path):
    """Seams, watchdog, rows, checkpoints and health all live: the same
    retire waits, dispatches and event order as the unsupervised run, and
    no ``torch.cuda.synchronize``."""
    counts = collections.Counter()
    fetch, scen = tp._Inflight.fetch, tp.scenario_megastep

    def counted_fetch(self):
        counts["fetch"] += 1
        return fetch(self)

    def counted_scen(*a, **k):
        counts["dispatch"] += 1
        return scen(*a, **k)

    def forbidden(*a, **k):
        raise AssertionError("torch.cuda.synchronize called inside the engine")

    monkeypatch.setattr(tp._Inflight, "fetch", counted_fetch)
    monkeypatch.setattr(tp, "scenario_megastep", counted_scen)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    runs = {}
    for tag in ("plain", "supervised"):
        counts.clear()
        events = []
        kw = dict(depth=3, rounds_per_dispatch=1, collect_decisions=True,
                  checkpoint_every=3, checkpoint_path=str(tmp_path / f"{tag}_{{round}}.npz"),
                  on_event=lambda kind, i, ev=events: ev.append((kind, i)), device="cpu")
        if tag == "plain":
            out = tp.pipeline_sweep(rng.key(23, device="cpu"), _tstate(), R, scenario=T_BLOCK,
                                    **kw)
        else:
            out = supervisor.supervised_sweep(
                rng.key(23, device="cpu"), _tstate(), R, scenario=T_BLOCK, health_every=1,
                config=supervisor.SupervisorConfig(timeout_s=60.0), **kw)
            assert out["supervisor"]["attempts"] == 1 and out["supervisor"]["retries"] == 0
            assert out["stats"]["stalls"] == 0 and out["stats"]["health_samples"] == R
        runs[tag] = (dict(counts), events, out["stats"]["max_in_flight"])
    assert runs["plain"] == runs["supervised"]
    assert runs["plain"][0] == {"fetch": R, "dispatch": R}
    assert runs["plain"][1][:5] == [("dispatch", i) for i in range(4)] + [("retire", 0)]


def _records(path, event):
    with open(path) as fh:
        return [r for r in map(json.loads, fh) if r.get("event") == event]


def test_recovery_records_and_flight_summary_match_the_reference(tmp_path):
    """With the sink on, the same ``recovery`` records (fault, action,
    attempt, from_round, lost_rounds), the same run id on every record,
    and flight summaries that agree on rounds, windows, checkpoints and
    recoveries."""
    plan = {"name": "drill", "faults": [{"round": 4, "kind": "corrupt"},
                                        {"round": 8, "kind": "fatal"},
                                        {"round": 10, "kind": "oom"}]}
    cfg = {"backoff_base_s": 0.01}
    got = {}
    for tag, run, metrics in (("t", _port, t_metrics), ("j", _ref, j_metrics)):
        sink = tmp_path / f"{tag}.jsonl"
        metrics.configure(str(sink))
        try:
            out = run(plan, cfg, checkpoint_every=EVERY,
                      checkpoint_path=str(tmp_path / f"{tag}_{{round}}.npz"))
        finally:
            metrics.configure(None)
        recs = _records(sink, "recovery")
        summary, = _records(sink, "flight_summary")
        got[tag] = {
            "recovery": [(r["fault"], r["action"], r["attempt"], r["from_round"],
                          r["lost_rounds"]) for r in recs],
            "run_ids": {r["run_id"] for r in recs} | {summary["run_id"]},
            "summary": {k: summary[k] for k in ("rounds", "contiguous", "windows")},
            "summary_recoveries": [(r["fault"], r["action"], r["from_round"])
                                   for r in summary["recoveries"]],
            "checkpoints": [c["round"] for c in summary["checkpoints"]],
        }
        assert got[tag]["run_ids"] == {out["supervisor"]["run_id"]}
    assert got["t"] == got["j"]
    assert [r[:2] for r in got["t"]["recovery"]] == [("fatal", "resume"), ("oom", "degrade")]
    assert got["t"]["summary"] == {"rounds": [0, R], "contiguous": True, "windows": R // RPD}


def test_fingerprints_and_run_ids_match_the_reference():
    j_dense = j_compile.compile_scenario(j_spec.from_dict(DOC), B, N)
    t_dense = t_compile.compile_scenario(t_spec.from_dict(DOC), B, N)
    pairs = [(None, None), (J_BLOCK, T_BLOCK), (j_dense, t_dense)]
    for j_block, t_block in pairs:
        for rounds in (R, 7):
            want = j_sup._campaign_fingerprint(jr.key(91), rounds, j_block)
            assert supervisor._campaign_fingerprint(rng.key(91, device="cpu"), rounds,
                                                    t_block) == want
    assert supervisor._campaign_fingerprint(None, R, None) is None
    assert supervisor._stream_names(True, True, True) == j_sup._stream_names(True, True, True)
    for flags in ((False, True, True), (False, False, True), (False, True, False)):
        assert supervisor._stream_names(*flags) == j_sup._stream_names(*flags)


def test_auto_resume_refuses_a_foreign_family_and_replays_a_finished_one(baseline, tmp_path):
    ck = str(tmp_path / "own_{round}.npz")
    first = _port(checkpoint_every=EVERY, checkpoint_path=ck)
    again = _port(checkpoint_every=EVERY, checkpoint_path=ck)  # replays the last window
    _same(first, baseline)
    _same(again, baseline)
    assert again["supervisor"]["history_start"] == 0
    foreign = str(tmp_path / "foreign_{round}.npz")
    tp.pipeline_sweep(rng.key(5, device="cpu"), _tstate(), R, scenario=T_BLOCK,
                      rounds_per_dispatch=RPD, device="cpu", checkpoint_every=EVERY,
                      checkpoint_path=foreign,
                      checkpoint_meta={"campaign_sha256": "f" * 64})
    with pytest.raises(supervisor.SupervisorError, match="DIFFERENT campaign"):
        _port(checkpoint_every=EVERY, checkpoint_path=foreign)


def test_prune_without_companions_keeps_the_sidecars(tmp_path):
    for r in (2, 4, 6):
        (tmp_path / f"c_{r}.npz").write_bytes(b"x")
        (tmp_path / f"c_{r}.npz.rows.npz").write_bytes(b"y")
    removed = snapshot.prune_checkpoints(str(tmp_path / "c_{round}.npz"), 1, companions=False)
    assert removed == [str(tmp_path / "c_2.npz"), str(tmp_path / "c_4.npz")]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "c_2.npz.rows.npz", "c_4.npz.rows.npz", "c_6.npz", "c_6.npz.rows.npz"]
    snapshot.prune_checkpoints(str(tmp_path / "c_{round}.npz"), 1)
    snapshot._atomic_write(str(tmp_path / "d.bin"), lambda tmp: open(tmp, "wb").close(),
                           durable=False)
    assert (tmp_path / "d.bin").exists()


def _sidecar_rows(template):
    """The stitched [0, R) history of a family's sidecars, by each package."""
    out = []
    for read in (supervisor._read_rows_chain, j_sup._read_rows_chain):
        blocks = read(template, NAMES)
        cover = supervisor._block_cover(blocks, 0, R)
        assert cover is not None
        out.append(supervisor._slice_cover(cover, 0, R, len(NAMES)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    return out[0]


JAX_CHILD = """
import dataclasses, jax.random as jr
from ba_tpu.parallel import make_sweep_state
from ba_tpu.runtime import chaos
from ba_tpu.runtime.supervisor import SupervisorConfig, supervised_sweep
from ba_tpu.scenario import compile_scenario, from_dict

state = make_sweep_state(jr.key(90), {B}, {N}, order=1)
state = dataclasses.replace(state, faulty=state.faulty.at[:{half}, 0].set(True))
block = compile_scenario(from_dict({doc!r}), {B}, {N}, sparse=True)
supervised_sweep(jr.key(91), state, scenario=block, rounds_per_dispatch={RPD},
                 collect_decisions=True, engine="xla", chaos=chaos.from_dict({plan!r}),
                 checkpoint_every={EVERY}, checkpoint_path={ck!r}, checkpoint_keep_last=1,
                 config=SupervisorConfig(timeout_s=60.0))
raise SystemExit("unreachable: the kill fault must have fired")
"""

PORT_CHILD = """
import numpy as np
from ba_tpu_torch import convert
from ba_tpu_torch.core import rng
from ba_tpu_torch.runtime import chaos
from ba_tpu_torch.runtime.supervisor import SupervisorConfig, supervised_sweep
from ba_tpu_torch.scenario import compile as t_compile, spec as t_spec

arrays = dict(np.load({arrays!r}))
state = convert.state_from_numpy(type("S", (), arrays), "cpu")
block = t_compile.compile_scenario(t_spec.from_dict({doc!r}), {B}, {N}, sparse=True)
supervised_sweep(rng.key(91, device="cpu"), state, scenario=block, rounds_per_dispatch={RPD},
                 collect_decisions=True, device="cpu", chaos=chaos.from_dict({plan!r}),
                 checkpoint_every={EVERY}, checkpoint_path={ck!r}, checkpoint_keep_last=1,
                 config=SupervisorConfig(timeout_s=60.0))
raise SystemExit("unreachable: the kill fault must have fired")
"""


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_killed_campaign_is_completed_by_the_other_package(writer, baseline, tmp_path):
    """A child of one package is SIGKILLed at round 10 (after the round-4
    checkpoint, before the round-8 one); the other package's
    ``resume="auto"`` completes the family bit-identically, with the same
    fingerprint and run id, and either package reads the sidecars."""
    ck = str(tmp_path / "kill_{round}.npz")
    plan = {"name": "mid-kill", "faults": [{"round": 10, "kind": "kill"}]}
    fmt = dict(B=B, N=N, half=B // 2, doc=DOC, RPD=RPD, EVERY=EVERY, plan=plan, ck=ck)
    if writer == "jax":
        code = JAX_CHILD.format(**fmt)
    else:
        np.savez(tmp_path / "arrays.npz", **ARRAYS)
        code = PORT_CHILD.format(arrays=str(tmp_path / "arrays.npz"), **fmt)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert (tmp_path / "kill_4.npz").exists() and (tmp_path / "kill_4.npz.rows.npz").exists()
    meta = snapshot.validate_carry_checkpoint(str(tmp_path / "kill_4.npz"))
    fingerprint = supervisor._campaign_fingerprint(rng.key(91, device="cpu"), R, T_BLOCK)
    assert meta["campaign_sha256"] == fingerprint
    kw = dict(checkpoint_every=EVERY, checkpoint_path=ck, checkpoint_keep_last=1)
    got = (_port if writer == "jax" else _ref)(**kw)
    _same(got, baseline)
    sup = got["supervisor"]
    assert (sup["history_start"], sup["attempts"], sup["run_id"]) == (0, 1, meta["run_id"])
    assert [r for r, _ in snapshot.checkpoint_paths(ck)] == [R]
    last = snapshot.validate_carry_checkpoint(ck.replace("{round}", str(R)))
    assert (last["campaign_sha256"], last["run_id"]) == (fingerprint, meta["run_id"])
    rows = _sidecar_rows(ck)
    np.testing.assert_array_equal(rows[NAMES.index("decisions")], baseline["decisions"])
    np.testing.assert_array_equal(rows[NAMES.index("leaders")], baseline["leaders"])
