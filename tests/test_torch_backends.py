"""The port's ``TorchBackend`` on the CPU against ``ba_tpu``'s ``JaxBackend``
(the XLA engine): the same REPL scripts print the same lines, byte for
byte, tolerance zero.  The port's threefry is bit-exact with jax's, so
the scripts whose output depends on the fault coins (faulty leaders, two
traitors at n = 5, the round-seed edges) must agree too; so must EIG,
SM, one signed round, ``run-rounds`` and ``scenario``.  One
``JaxBackend`` per configuration serves the whole module, so its jit
compiles are paid once."""

import dataclasses
import json
import pathlib

import jax
import jax.random as jr
import numpy as np
import pytest

from ba_tpu.runtime.backends import JaxBackend
from ba_tpu.runtime.cluster import Cluster as JCluster
from ba_tpu.runtime.repl import handle_command as j_handle_command
from ba_tpu.scenario import spec as j_spec
from ba_tpu_torch.core import rng
from ba_tpu_torch.runtime.backends import PyBackend, TorchBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.repl import handle_command
from ba_tpu_torch.scenario import spec as t_spec
from ba_tpu_torch.utils.snapshot import validate_carry_checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = {"om1": {}, "om2": {"m": 2}, "om3": {"m": 3}, "sm1": {"protocol": "sm"},
           "sm2": {"protocol": "sm", "m": 2}, "signed": {"protocol": "sm", "signed": True}}


@pytest.fixture(scope="module")
def jax_backends():
    return {}


def _jax_backend(jax_backends, config):
    if config not in jax_backends:
        jax_backends[config] = JaxBackend(platform="cpu", **CONFIGS[config])
    return jax_backends[config]


def drive(cluster, lines, handle=handle_command):
    out = []
    for line in lines:
        if not handle(cluster, line, out.append):
            break
    return out


def both(jax_backends, config, n, seed, script):
    """The script's lines from the port (TorchBackend on the CPU) and from
    the reference (JaxBackend), and the two clusters after it."""
    port = Cluster(n, TorchBackend(device="cpu", **CONFIGS[config]), seed=seed)
    ref = JCluster(n, _jax_backend(jax_backends, config), seed=seed)
    return drive(port, script), drive(ref, script, j_handle_command), port, ref


def assert_same_roster(port, ref):
    assert [(g.id, g.port, g.faulty, g.alive) for g in port.generals] == \
        [(g.id, g.port, g.faulty, g.alive) for g in ref.generals]
    assert (port.leader_id, port._round, port._next_id) == (ref.leader_id, ref._round,
                                                            ref._next_id)


# tests/test_backends.py:24-37, deterministic at n = 5, seed 7
SCRIPTS = [
    ["actual-order attack"],
    ["actual-order retreat"],
    ["g-state 3 faulty", "actual-order attack"],
    ["g-kill 2", "actual-order retreat"],
    ["g-kill 1", "g-add 1", "actual-order attack", "List"],
    ["g-add 2", "g-state 2 faulty", "g-state 4 faulty", "actual-order retreat"],
    ["actual-order charge"],
]


@pytest.mark.parametrize("script", SCRIPTS, ids=[" ".join(s)[:40] for s in SCRIPTS])
def test_deterministic_scripts_match_the_reference(jax_backends, script):
    got, want, port, ref = both(jax_backends, "om1", 5, 7, script)
    assert got == want
    assert got == drive(Cluster(5, PyBackend(), seed=7), script)
    assert_same_roster(port, ref)


FAULTY_LEADER = ["g-state 1 faulty", "actual-order attack", "actual-order retreat",
                 "g-add 3", "actual-order attack"]  # n = 5, then 8 (capacity 8)
TWO_TRAITORS = ["g-state 2 faulty", "g-state 4 faulty", "actual-order retreat",
                "actual-order attack", "g-state 1 faulty", "actual-order attack"]


@pytest.mark.parametrize("seed", range(6))
def test_faulty_leader_coins_match_the_reference(jax_backends, seed):
    got, want, port, ref = both(jax_backends, "om1", 5, seed, FAULTY_LEADER)
    assert got == want
    assert_same_roster(port, ref)


@pytest.mark.parametrize("seed", [0, 2048, -3])
def test_two_traitors_at_n5_and_round_seed_edges(jax_backends, seed):
    # seed 2048: (seed << 20) ^ round passes 2**31; seed -3: it is negative
    got, want, _, _ = both(jax_backends, "om1", 5, seed, TWO_TRAITORS)
    assert got == want


@pytest.mark.parametrize("s", [0, 7, 2**31, 2**31 + 5, 2**32 - 1, -3, (-3 << 20) ^ 1])
def test_round_seed_keys_match_jax(s):
    want = np.asarray(jax.random.key_data(jr.key(s)))
    assert rng.key(s, device="cpu").tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("config,n,script", [
    ("om3", 6, ["actual-order attack", "g-kill 3", "actual-order retreat"]),
    ("om3", 7, ["g-state 1 faulty", "g-state 4 faulty", "actual-order attack",
                "actual-order retreat"]),
    ("om2", 5, ["g-state 3 faulty", "actual-order attack", "g-state 1 faulty",
                "actual-order retreat"]),
    ("sm1", 5, ["actual-order attack", "g-state 1 faulty", "actual-order attack",
                "g-kill 2", "actual-order retreat"]),
    ("sm2", 6, ["g-state 1 faulty", "g-state 3 faulty", "actual-order attack"]),
], ids=["om3_honest", "om3_faulty", "om2_faulty_leader", "sm1", "sm2"])
def test_eig_and_sm_match_the_reference(jax_backends, config, n, script):
    got, want, _, _ = both(jax_backends, config, n, 1, script)
    assert got == want


def test_one_signed_round_matches_the_reference(jax_backends):
    got, want, _, _ = both(jax_backends, "signed", 4, 1,
                           ["actual-order retreat", "g-state 1 faulty", "actual-order attack"])
    assert got == want
    assert got[4] == ("Execute order: retreat! Non-faulty nodes in the system - "
                      "3 out of 4 quorum suggests retreat")


def test_run_rounds_matches_the_reference(jax_backends):
    # tests/test_pipeline.py:426-446
    got, want, port, ref = both(jax_backends, "om1", 4, 0, ["run-rounds attack 5"])
    assert got == want
    assert got[4:] == [
        "Execute order: attack! Non-faulty nodes in the system"
        " - 3 out of 4 quorum suggests attack",
        "Rounds: 5 - attack=5, retreat=0, undefined=0",
    ]
    assert port._round == ref._round == 5


@pytest.mark.parametrize("config,n,script", [
    ("om1", 5, ["g-state 1 faulty", "run-rounds attack 7", "actual-order retreat"]),
    ("om1", 9, ["g-state 2 faulty", "g-state 5 faulty", "run-rounds retreat 12"]),
    ("om2", 5, ["g-state 1 faulty", "run-rounds attack 3"]),
    ("sm1", 5, ["g-state 1 faulty", "run-rounds attack 3"]),  # sequential in both
], ids=["faulty_leader", "two_traitors_n9", "om2", "sm1_sequential"])
def test_coin_sensitive_run_rounds_match_the_reference(jax_backends, config, n, script):
    got, want, port, ref = both(jax_backends, config, n, 3, script)
    assert got == want
    assert_same_roster(port, ref)


def test_noncanonical_run_rounds_takes_the_quirk_path(jax_backends):
    # tests/test_pipeline.py:458-476
    port = Cluster(4, TorchBackend(device="cpu"), seed=0)
    res, counts, stats = port.actual_order_rounds("charge", 2)
    assert stats is None  # sequential, not the pipeline
    ref = JCluster(4, _jax_backend(jax_backends, "om1"), seed=0)
    want, want_counts, _ = ref.actual_order_rounds("charge", 2)
    assert dataclasses.astuple(res) == dataclasses.astuple(want) and counts == want_counts
    assert res.per_general[0][2] == "charge"
    py, py_counts, _ = Cluster(4, PyBackend(), seed=0).actual_order_rounds("charge", 2)
    assert py_counts == counts and py.decision == res.decision


def test_signed_run_rounds_raises():
    """A signed backend's ``run_rounds`` refuses the fused CUDA engine,
    which has no signed form, before it runs a round."""
    gens = Cluster(4, PyBackend(), seed=0).generals
    backend = TorchBackend(device="cpu", protocol="sm", signed=True)
    with pytest.raises(ValueError, match="signed"):
        backend.run_rounds(gens, 0, 1, 42, 3, engine="cuda")


def test_signed_run_rounds_matches_the_reference(jax_backends, monkeypatch):
    """A signed backend's ``run_rounds`` runs the signed pipelined engine:
    the last round's majorities, the decisions and the signed counters
    equal ``JaxBackend``'s (its pool off)."""
    from ba_tpu.crypto import pool as j_pool

    from ba_tpu_torch.crypto import pool as t_pool

    monkeypatch.setenv("BA_TPU_SIGN_POOL", "0")
    monkeypatch.setattr(t_pool, "default_workers", lambda: 0)
    j_pool.shutdown_defaults()
    t_pool.shutdown_defaults()
    try:
        gens = Cluster(4, PyBackend(), seed=0).generals
        gens[1].faulty = True
        backend = TorchBackend(device="cpu", protocol="sm", signed=True)
        got = backend.run_rounds(gens, 0, 1, 42, 6)
        want = _jax_backend(jax_backends, "signed").run_rounds(gens, 0, 1, 42, 6)
    finally:
        j_pool.shutdown_defaults()
        t_pool.shutdown_defaults()
    assert got[:2] == tuple(want[:2])
    assert got[2]["counters"] == want[2]["counters"]
    assert got[2]["signed"] is True and got[2]["dispatches"] == want[2]["dispatches"] == 1


def _spec(tmp_path, doc, name="spec.json"):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


REPL_SPEC = {"name": "repl", "rounds": 4, "order": "attack",
             "events": [{"round": 1, "kill": [1]},
                        {"round": 2, "set_faulty": [3], "value": True},
                        {"round": 3, "kill": [2]}]}


def test_scenario_command_matches_the_reference(jax_backends, tmp_path):
    # tests/test_scenario.py:1469-1498, then coin-sensitive rounds after it
    path = _spec(tmp_path, REPL_SPEC)
    script = [f"scenario {path}", "g-state", "actual-order attack",
              f"scenario {ROOT / 'examples' / 'scenarios' / 'colluding_coalition.json'}",
              "g-state", "run-rounds retreat 3"]
    got, want, port, ref = both(jax_backends, "om1", 5, 0, script[:3])
    assert got == want
    assert got[0].startswith("Scenario repl: 4 rounds - ")
    assert got[1].startswith("Scenario counters: quorum_failures=")
    assert [g.id for g in port.generals] == [3, 4, 5] and port.leader_id == 3
    assert port.find(3).faulty and got[2] == "G3, primary, state=F"
    assert_same_roster(port, ref)
    got, want, port, ref = both(jax_backends, "om1", 12, 4, script[3:])
    assert got == want
    assert_same_roster(port, ref)


def test_scenario_checkpoints_match_the_reference(jax_backends, tmp_path):
    path = _spec(tmp_path, REPL_SPEC)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port = Cluster(5, TorchBackend(device="cpu"), seed=0)
    ref = JCluster(5, _jax_backend(jax_backends, "om1"), seed=0)
    got = drive(port, [f"scenario {path} {tmp_path}/port/ck_{{round}}.npz 2"])
    want = drive(ref, [f"scenario {path} {tmp_path}/ref/ck_{{round}}.npz 2"], j_handle_command)
    assert got[:2] == want[:2]
    # one dispatch of the 4 rounds: the checkpoint lands at its end
    assert got[2] == f"Scenario checkpoints: 1 -> {tmp_path}/port/ck_{{round}}.npz"
    assert want[2] == f"Scenario checkpoints: 1 -> {tmp_path}/ref/ck_{{round}}.npz"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["ck_4.npz"]
    meta = validate_carry_checkpoint(str(tmp_path / "port" / "ck_4.npz"))
    assert meta == validate_carry_checkpoint(str(tmp_path / "ref" / "ck_4.npz"))


def test_scenario_command_guards(jax_backends, tmp_path):
    # tests/test_scenario.py:1501-1568
    path = _spec(tmp_path, {"name": "s", "rounds": 1, "events": []})
    assert drive(Cluster(4, PyBackend(), seed=0), [f"scenario {path}"]) == []
    bad = _spec(tmp_path, {"name": "s", "rounds": 1, "events": [{"round": 0, "kill": [99]}]},
                "bad.json")
    same = ["scenario /definitely/not/there.json", f"scenario {bad}", f"scenario {path} ",
            f"scenario {path} ck.npz", f"scenario {path} ck.npz 1 500",
            f"scenario {path} ck.npz x", f"scenario {path} ck.npz 0",
            f"scenario {path} mesh=zero", f"scenario {path} mesh=0"]
    got, want, port, ref = both(jax_backends, "om1", 4, 0, same)
    assert got == want
    assert got[0].startswith("scenario error:") and "not in the roster" in got[1]
    assert got[2].startswith("Scenario s:")
    assert got[5] == ("scenario error: too many arguments (usage: scenario <file> "
                      "[<ckpt-path> <every>] [supervise] [mesh=N] [engine=...])")
    assert got[-2] == "scenario error: mesh= wants a device count, got 'zero'"
    assert_same_roster(port, ref)
    out = drive(port, [f"scenario {path} {tmp_path}/no/such/dir/ck.npz 1"])
    assert len(out) == 1 and out[0].startswith("scenario error:")
    for line, want_line in [
        (f"scenario {path} engine=", "scenario error: engine= wants one of torch|cuda|auto"),
        (f"scenario {path} engine=bogus",
         "scenario error: engine='bogus' unknown; choose from ('torch', 'cuda')"),
        (f"scenario {path} engine=cuda",
         "scenario error: engine='cuda' runs on a CUDA device, not cpu"),
        (f"scenario {path} mesh=8",
         "scenario error: mesh shape (8, 1) needs 8 device(s) but only 1 are available — "
         "shrink the shape or pass devices= with more entries (an entry may repeat a "
         "device)"),
    ]:
        assert drive(port, [line]) == [want_line]
    # supervise, ported since: the reference's lines, its supervisor line last
    got, want, port, ref = both(jax_backends, "om1", 4, 0, [f"scenario {path} supervise"])
    assert got == want
    assert got[-1] == "Scenario supervisor: attempts=1, retries=0, recoveries=0, stalls=0"
    assert_same_roster(port, ref)
    for engine in ("torch", "auto"):
        assert drive(port, [f"scenario {path} engine={engine}"])[0].startswith("Scenario s:")


def test_run_scenario_unported_options_raise(jax_backends, tmp_path, monkeypatch):
    """Ported since: ``fault_plan`` without ``supervise`` raises the
    reference's error before anything runs; a supervised rerun over
    checkpoints written unsupervised (no rows sidecars) refuses the
    partial history as the reference does (tests/test_supervisor.py:922);
    ``health_every`` samples as the reference's engine does."""
    from ba_tpu.runtime import chaos as j_chaos
    from ba_tpu_torch.runtime import chaos

    backend = TorchBackend(device="cpu", rounds_per_dispatch=2)
    cluster = Cluster(4, backend, seed=0)
    j_backend = _jax_backend(jax_backends, "om1")
    j_cluster = JCluster(4, j_backend, seed=0)
    plan = {"name": "t", "faults": [{"round": 3, "kind": "transient"}]}
    errors = []
    for run, generals, fault_plan in (
            (backend.run_scenario, cluster.generals, chaos.from_dict(plan)),
            (j_backend.run_scenario, j_cluster.generals, j_chaos.from_dict(plan))):
        with pytest.raises(ValueError) as exc:
            run(generals, 0, 1, 0, object(), fault_plan=fault_plan)  # never reaches the spec
        errors.append(str(exc.value))
    assert errors[0] == errors[1] == "fault_plan requires supervise=True"

    doc = {"name": "wire", "order": "attack", "rounds": 8,
           "events": [{"round": 2, "kill": [2]}, {"round": 5, "revive": [2]}]}
    monkeypatch.setenv("BA_TPU_PIPELINE_ROUNDS", "2")  # the reference's rounds a dispatch

    def port():
        return Cluster(4, TorchBackend(device="cpu", rounds_per_dispatch=2), seed=7)

    def ref():
        return JCluster(4, JaxBackend(platform="cpu", m=1), seed=7)

    for tag, make, spec in (("t", port, t_spec.from_dict(doc)),
                            ("j", ref, j_spec.from_dict(doc))):
        ck = str(tmp_path / f"{tag}_un_{{round}}.npz")
        make().run_scenario(spec, checkpoint_every=4, checkpoint_path=ck)
        with pytest.raises(ValueError, match="sidecars"):
            make().run_scenario(spec, checkpoint_every=4, checkpoint_path=ck, supervise=True)

    got = port().run_scenario(t_spec.from_dict(doc), health_every=2, supervise=True,
                              fault_plan=chaos.from_dict(plan))
    want = ref().run_scenario(j_spec.from_dict(doc), health_every=2, supervise=True,
                              fault_plan=j_chaos.from_dict(plan))
    assert got[0] == want[0]
    for key in ("decisions", "leaders", "counters", "alive", "faulty"):
        assert got[1][key] == want[1][key], key
    assert got[1]["stats"]["health_samples"] == want[1]["stats"]["health_samples"] == 2
    sup, j_sup = dict(got[1]["stats"]["supervisor"]), dict(want[1]["stats"]["supervisor"])
    sup.pop("timeout_s"), j_sup.pop("timeout_s")
    assert sup == j_sup and sup["retries"] == 1


def test_scenario_mesh_one_matches_the_reference(jax_backends, tmp_path):
    """``scenario <file> mesh=1`` runs the B = 1 campaign through the mesh
    path: the reference's bytes, and the bytes of the same command
    without ``mesh=``; the roster ends the same."""
    path = _spec(tmp_path, REPL_SPEC)
    coalition = ROOT / "examples" / "scenarios" / "colluding_coalition.json"
    for n, seed, spec in ((5, 0, path), (12, 4, coalition)):
        script = [f"scenario {spec} mesh=1", "g-state", "actual-order attack"]
        got, want, port, ref = both(jax_backends, "om1", n, seed, script)
        assert got == want
        assert got[0].startswith("Scenario ")
        assert_same_roster(port, ref)
        plain, _, plain_port, _ = both(jax_backends, "om1", n, seed,
                                       [f"scenario {spec}", *script[1:]])
        assert plain == got
        assert_same_roster(plain_port, ref)


def test_run_scenario_takes_a_mesh(tmp_path):
    """``TorchBackend.run_scenario(mesh=)`` runs (a one-entry mesh, the
    facade's B = 1) and equals the run without one."""
    from ba_tpu_torch.parallel.mesh import make_mesh
    from ba_tpu_torch.scenario import spec as t_spec

    spec = t_spec.load(_spec(tmp_path, REPL_SPEC))
    runs = []
    for mesh in (None, make_mesh((1, 1), devices=["cpu"])):
        backend = TorchBackend(device="cpu")
        cluster = Cluster(5, backend, seed=0)
        runs.append(backend.run_scenario(cluster.generals, 0, 1, 3, spec, mesh=mesh))
    assert runs[1]["stats"]["shards"] == 1 and runs[1]["stats"]["engine"] == "torch"
    for key in ("decisions", "leaders", "counters", "alive", "faulty"):
        assert runs[0][key] == runs[1][key], key
    with pytest.raises(ValueError, match="not divisible"):
        backend.run_scenario(cluster.generals, 0, 1, 3, spec,
                             mesh=make_mesh((2, 1), devices=["cpu"] * 2))


def test_capacity_follows_the_roster():
    backend = TorchBackend(device="cpu")
    cluster = Cluster(3, backend, seed=0)
    assert backend._make_state(cluster.generals, 0, 1).faulty.shape == (1, 4)
    drive(cluster, ["g-add 1", "actual-order attack"])
    assert backend._make_state(cluster.generals, 0, 1).faulty.shape == (1, 4)
    drive(cluster, ["g-add 1", "actual-order attack"])
    assert backend._make_state(cluster.generals, 0, 1).faulty.shape == (1, 8)


def test_survey_script_golden_is_the_reference_output(jax_backends):
    """chip_smoke's repl_cuda phase holds the card's launcher output
    against this golden text: it is what the reference prints."""
    import chip_smoke

    script = chip_smoke.REPL_SCRIPT.splitlines()
    ref = JCluster(4, _jax_backend(jax_backends, "om1"), seed=0)
    want = drive(ref, script, j_handle_command)
    assert chip_smoke.REPL_GOLDEN.splitlines() == want
    port = drive(Cluster(4, TorchBackend(device="cpu"), seed=0), script)
    assert port == want
    py = drive(Cluster(4, PyBackend(), seed=0), script)
    k = chip_smoke.REPL_COIN_FREE_LINES
    assert py[:k] == want[:k] and py != want  # the py oracle's own coins after that


def test_repl_mesh_golden_is_the_reference_output(jax_backends):
    """chip_smoke's repl_mesh phase holds the card's ``scenario ... mesh=1``
    against this golden text: it is what the reference prints, and what
    the port prints on the CPU."""
    import chip_smoke

    script = list(chip_smoke.REPL_MESH_SCRIPT)
    ref = JCluster(4, _jax_backend(jax_backends, "om1"), seed=0)
    want = drive(ref, script, j_handle_command)
    assert chip_smoke.REPL_MESH_GOLDEN.splitlines() == want
    assert drive(Cluster(4, TorchBackend(device="cpu"), seed=0), script) == want
