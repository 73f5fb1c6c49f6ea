"""The port's adversary search (``ba_tpu_torch/search/``) against the JAX
package's (``ba_tpu/search/``) on the CPU, tolerance zero.

The reference runs ``engine="xla"``.  One seed samples the same population
in both packages, a population's counter rows are the same, and a hunt's
whole result (``found``, ``elites``, ``minimized``, the final ``state``
doc and the run id) is the same; only walls and time stamps differ.
Search checkpoints cross the packages both ways.  The committed
reproducers' counters are recomputed with the reference's
``evaluate_alone(engine="xla")`` (their provenance was written by an
older toolchain) and the port meets them bit for bit.  The shapes are
``tests/test_search.py``'s, so each XLA program compiles once."""

import functools
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from ba_tpu.runtime import backends as j_backends
from ba_tpu.runtime.cluster import Cluster as JCluster
from ba_tpu.runtime.repl import handle_command as j_handle
from ba_tpu.search import corpus as j_corpus
from ba_tpu.search import generate as j_gen
from ba_tpu.search import loop as j_loop
from ba_tpu.search import objective as j_obj
from ba_tpu.utils import snapshot as j_snapshot
from ba_tpu_torch.core.types import UNDEFINED
from ba_tpu_torch.parallel.mesh import make_mesh
from ba_tpu_torch.runtime.backends import PyBackend, TorchBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.repl import handle_command
from ba_tpu_torch.scenario.spec import ScenarioError, from_dict, to_dict
from ba_tpu_torch.search import corpus, generate, loop, minimize, objective
from ba_tpu_torch.utils import snapshot

REPO = pathlib.Path(__file__).resolve().parent.parent
DOC = {"rounds": 4, "capacity": 6, "population": 8, "events_min": 2, "events_max": 5}
SPACE = generate.space_from_dict(DOC)
J_SPACE = j_gen.space_from_dict(DOC)
CPU = torch.device("cpu")


def _hunt(**kw):
    return loop.hunt(device="cpu", **kw)


def _j_hunt(**kw):
    return j_loop.hunt(engine="xla", **kw)


@functools.lru_cache(maxsize=None)
def _j_hunt_cached(seed, generations, minimize_max):
    return _j_hunt(space=J_SPACE, seed=seed, generations=generations,
                   minimize=minimize_max > 0, minimize_max=minimize_max)


def _same_hunt(ours, theirs):
    for key in ("found", "elites", "minimized", "state"):
        assert ours[key] == theirs[key], key
    assert ours["stats"]["run_id"] == theirs["stats"]["run_id"]


# -- the layers without an engine ---------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(population=0), dict(events_min=5, events_max=2), dict(strategies=("nope",)),
    dict(kinds=()), dict(faulty_max=99), dict(ids_per_event=7), dict(order="march"),
])
def test_space_validation_eager(bad):
    kw = {"rounds": 4, "capacity": 6, "population": 4, **bad}
    with pytest.raises(ScenarioError) as ours:
        generate.validate_space(generate.SearchSpace(**kw))
    with pytest.raises(ValueError) as theirs:
        j_gen.validate_space(j_gen.SearchSpace(**kw))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ScenarioError, match="unknown search objective"):
        objective.get_objective("win")


def test_space_doc_round_trip_and_unknown_keys():
    doc = generate.space_to_dict(SPACE)
    assert doc == j_gen.space_to_dict(J_SPACE)
    assert generate.space_to_dict(generate.space_from_dict(json.loads(json.dumps(doc)))) == doc
    with pytest.raises(ScenarioError, match="unknown search space"):
        generate.space_from_dict({**doc, "zap": 1})
    with pytest.raises(ScenarioError, match="missing"):
        generate.space_from_dict({"rounds": 4})


def test_generator_matches_the_reference_and_keeps_budgets():
    pop = generate.sample_population(SPACE, seed=11)
    assert [to_dict(c) for c in pop] == [to_dict(c) for c in
                                         j_gen.sample_population(J_SPACE, seed=11)]
    assert [to_dict(c) for c in pop] != [to_dict(c) for c in
                                         generate.sample_population(SPACE, seed=12)]
    tight = dict(rounds=4, capacity=6, population=16, events_min=2, events_max=5,
                 faulty_max=1, kill_max=2)
    got = generate.sample_population(generate.SearchSpace(**tight), seed=5)
    assert [to_dict(c) for c in got] == [
        to_dict(c) for c in j_gen.sample_population(j_gen.SearchSpace(**tight), seed=5)]
    for c in got:
        assert len(c.events) <= 5
        assert len({g for ev in c.events if ev.kind == "set_faulty" and ev.value
                    for g in ev.ids}) <= 1
        assert len({g for ev in c.events if ev.kind == "kill" for g in ev.ids}) <= 2
    flap = dict(rounds=2, capacity=4, population=4, events_min=4, events_max=8,
                kinds=generate.EVENT_KINDS)
    for uid in range(0, 300, 7):  # the full kind menu samples clean, as the reference's
        assert to_dict(generate.sample_campaign(generate.SearchSpace(**flap), 0, uid)) == \
            to_dict(j_gen.sample_campaign(j_gen.SearchSpace(**flap), 0, uid))
    for uid in (500, 501, 502, 503):
        child = generate.mutate_campaign(pop[0], SPACE, 11, uid)
        assert to_dict(child) == to_dict(j_gen.mutate_campaign(
            j_gen.sample_population(J_SPACE, seed=11)[0], J_SPACE, 11, uid))
    assert generate.mutate_campaign(pop[0], SPACE, 11, 500).name == "search-s11-u500"


def test_lower_population_confines_events_to_instances():
    from ba_tpu_torch.scenario.compile import compile_scenario

    pop = generate.sample_population(SPACE, seed=11)
    planes = generate.lower_population(pop, SPACE.capacity, SPACE.rounds).chunk(0, SPACE.rounds)
    theirs = j_gen.lower_population(j_gen.sample_population(J_SPACE, seed=11),
                                    SPACE.capacity, SPACE.rounds).chunk(0, SPACE.rounds)
    for name in planes:
        np.testing.assert_array_equal(planes[name], theirs[name])
    for i, campaign in enumerate(pop):
        single = compile_scenario(campaign, batch=1, capacity=SPACE.capacity)
        for name in ("kill", "set_faulty", "set_strategy"):
            np.testing.assert_array_equal(planes[name][:, i], getattr(single, name)[:, 0])
    assert (planes["set_faulty"] >= 0).sum() == sum(
        (compile_scenario(c, batch=1, capacity=SPACE.capacity).set_faulty >= 0).sum()
        for c in pop)


def test_objective_scores_and_errors():
    names = ("quorum_failures", "unanimous_rounds", "equivocation_observed",
             "ic1_violations", "ic2_violations")
    rows = np.array([[0, 4, 0, 0, 0], [2, 4, 1, 3, 1]], np.int32)
    for name in objective.OBJECTIVES:
        assert list(objective.score_rows(rows, names, name)) == \
            list(j_obj.score_rows(rows, names, name))
        assert list(objective.violation_rows(rows, names, name)) == \
            list(j_obj.violation_rows(rows, names, name))
    assert list(objective.score_rows(rows, names, "havoc")) == [0, 8 * 3 + 8 + 4 + 1]
    assert objective.counters_dict(rows[1], names)["ic1_violations"] == 3
    with pytest.raises(ScenarioError, match="not in the run's table"):
        objective.score_rows(rows, ("a", "b", "c", "d", "e"), "ic")
    with pytest.raises(ScenarioError, match="expected"):
        objective.score_rows(rows[0], names, "ic")
    assert set(objective.OBJECTIVES) == set(j_obj.OBJECTIVES)


def test_search_checkpoint_format_crosses_packages(tmp_path):
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    snapshot.write_search_checkpoint(ours, {"seed": 1, "found": []}, run_id="run-abc")
    j_snapshot.write_search_checkpoint(theirs, {"seed": 1, "found": []}, run_id="run-abc")
    assert pathlib.Path(ours).read_bytes() == pathlib.Path(theirs).read_bytes()
    assert snapshot.read_search_checkpoint(theirs) == j_snapshot.read_search_checkpoint(ours)
    meta, state = snapshot.read_search_checkpoint(ours)
    assert state == {"seed": 1, "found": []} and meta["run_id"] == "run-abc"
    assert meta["format"] == "ba_tpu.search_state"
    doc = json.load(open(ours))
    doc["state"]["seed"] = 2
    open(ours, "w").write(json.dumps(doc))
    with pytest.raises(ValueError, match="digest mismatch"):
        snapshot.read_search_checkpoint(ours)
    open(ours, "w").write("{not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        snapshot.read_search_checkpoint(ours)
    open(ours, "w").write('{"format": "other", "v": 1}')
    with pytest.raises(ValueError, match="format"):
        snapshot.read_search_checkpoint(ours)


def test_cli_sample_and_corpus_print_the_reference_lines(tmp_path, capsys):
    from ba_tpu.search.__main__ import main as j_main
    from ba_tpu_torch.search.__main__ import main

    path = tmp_path / "space.json"
    path.write_text(json.dumps(DOC))
    found = str(REPO / "examples" / "scenarios" / "found")
    for argv in (["sample", str(path), "--seed", "3", "--count", "5"], ["corpus", found]):
        assert main(argv) == 0
        ours = capsys.readouterr().out
        assert j_main(argv) == 0
        assert ours == capsys.readouterr().out
    (tmp_path / "empty").mkdir()
    assert main(["corpus", str(tmp_path / "empty")]) == 1
    assert "holds no .json reproducers" in capsys.readouterr().err
    assert main(["hunt"]) == 2


def test_export_refuses_non_bit_exact(tmp_path):
    entry = {"doc": to_dict(generate.sample_campaign(SPACE, 11, 0)), "uid": 0,
             "generation": 0, "score": 1, "counters": {"ic1_violations": 1},
             "bit_exact": False}
    with pytest.raises(ScenarioError, match="parity oracle"):
        corpus.export_found([entry], str(tmp_path), seed=11, objective="ic",
                            capacity=SPACE.capacity)


# -- the engine ---------------------------------------------------------------


def test_population_rows_match_the_reference_and_each_candidate_alone():
    pop = generate.sample_population(SPACE, seed=3)
    uids = list(range(len(pop)))
    block = generate.lower_population(pop, SPACE.capacity, SPACE.rounds)
    res = loop.evaluate_population(
        loop.candidate_keys(3, uids), loop.population_state(len(pop), SPACE.capacity,
                                                             SPACE.order, CPU),
        block, rounds=SPACE.rounds, device=CPU)
    j_pop = j_gen.sample_population(J_SPACE, seed=3)
    want = j_loop.evaluate_population(
        j_loop.candidate_keys(3, uids),
        j_loop.population_state(len(pop), SPACE.capacity, SPACE.order),
        j_gen.lower_population(j_pop, SPACE.capacity, SPACE.rounds),
        rounds=SPACE.rounds, engine="xla")
    for key in ("counters", "decisions", "leaders"):
        np.testing.assert_array_equal(res[key], np.asarray(want[key]))
    assert list(res["counter_names"]) == list(want["counter_names"])
    rows, names = res["counters"], res["counter_names"]
    violations = objective.violation_rows(rows, names, "ic")
    assert violations.any(), "the seeded sweep lost its violating campaigns"
    q = list(names).index("quorum_failures")
    np.testing.assert_array_equal(rows[:, q], (res["decisions"] == UNDEFINED).sum(axis=0))
    for i in np.flatnonzero(violations)[:2]:
        alone = loop.evaluate_alone(pop[i], seed=3, uid=uids[i], capacity=SPACE.capacity,
                                    device=CPU)
        np.testing.assert_array_equal(alone["counters"], rows[i])
        np.testing.assert_array_equal(alone["decisions"], res["decisions"][:, i])
        np.testing.assert_array_equal(alone["leaders"], res["leaders"][:, i])


def test_hunt_matches_the_reference_finds_shrinks_and_reproduces(tmp_path):
    res = _hunt(space=SPACE, seed=3, generations=2, objective="ic", minimize=True,
                minimize_max=2, export_dir=str(tmp_path / "found"))
    _same_hunt(res, _j_hunt_cached(3, 2, 2))
    assert res["stats"]["found"] >= 1 and res["minimized"]
    assert res["stats"]["engine"] == "torch" and res["stats"]["lower_s"] > 0
    for m in res["minimized"]:
        assert m["bit_exact"] is True and m["events_after"] <= m["events_before"]
        alone = loop.evaluate_alone(from_dict(m["doc"]), seed=3, uid=m["uid"],
                                    capacity=SPACE.capacity, device=CPU)
        assert objective.counters_dict(alone["counters"], alone["counter_names"]) == \
            m["counters"]
    specs = corpus.load_corpus(str(tmp_path / "found"))
    assert len(specs) == len(res["minimized"])
    assert all(s.provenance["search"]["capacity"] == SPACE.capacity for s in specs)
    assert j_corpus.load_corpus(str(tmp_path / "found"))  # the reference reads them too
    fps = [generate.campaign_fingerprint(from_dict(e["doc"])) for e in res["found"]]
    assert len(fps) == len(set(fps))


def test_hunt_records_and_counters_match_the_reference(tmp_path):
    from ba_tpu.obs.registry import MetricsRegistry as JRegistry
    from ba_tpu.utils import metrics as j_metrics
    from ba_tpu_torch import obs
    from ba_tpu_torch.obs.registry import MetricsRegistry
    from ba_tpu_torch.utils import metrics as t_metrics
    from ba_tpu import obs as j_obs

    def run(metrics_mod, obs_mod, registry, fn, path):
        prev = obs_mod.registry._default
        obs_mod.registry._default = registry
        metrics_mod.configure(str(path))
        try:
            fn(space_doc=None)
        finally:
            metrics_mod.configure(None)
            obs_mod.registry._default = prev
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        return [{k: v for k, v in r.items() if k not in ("ts", "wall_s", "t_perf")}
                for r in recs if r.get("event", "").startswith("search_")]

    kw = dict(seed=3, generations=2, minimize_max=1,
              checkpoint_path=str(tmp_path / "{generation}.json"))
    ours_reg, theirs_reg = MetricsRegistry(), JRegistry()
    ours = run(t_metrics, obs, ours_reg, lambda space_doc: _hunt(space=SPACE, **kw),
               tmp_path / "ours.jsonl")
    kw["checkpoint_path"] = str(tmp_path / "j{generation}.json")
    theirs = run(j_metrics, j_obs, theirs_reg, lambda space_doc: _j_hunt(space=J_SPACE, **kw),
                 tmp_path / "theirs.jsonl")
    for rec in ours + theirs:
        rec.pop("path", None)
    assert ours == theirs and ours
    for name in ("search_generations_total", "search_campaigns_total",
                 "search_found_total", "search_checkpoints_total"):
        assert ours_reg.counter(name).value == theirs_reg.counter(name).value, name
    assert ours_reg.gauge("search_best_score").value == \
        theirs_reg.gauge("search_best_score").value


def test_hunt_checkpoint_resume_bit_exact_across_packages(tmp_path):
    ck = str(tmp_path / "hunt_g{generation}.json")
    full = _hunt(space=SPACE, seed=3, generations=3, minimize_max=1, checkpoint_path=ck)
    assert full["stats"]["checkpoints"] == 3
    resumed = _hunt(resume=str(tmp_path / "hunt_g1.json"), generations=3, minimize_max=1)
    _same_hunt(resumed, full)
    # the reference resumes the port's checkpoint, and the port the reference's
    theirs = _j_hunt(resume=str(tmp_path / "hunt_g2.json"), generations=3, minimize_max=1)
    _same_hunt(theirs, full)
    j_ck = str(tmp_path / "j_g{generation}.json")
    _j_hunt(space=J_SPACE, seed=3, generations=3, minimize=False, checkpoint_path=j_ck)
    _same_hunt(_hunt(resume=str(tmp_path / "j_g1.json"), generations=3, minimize_max=1), full)
    with pytest.raises(ScenarioError, match="different search space"):
        _hunt(space=generate.SearchSpace(rounds=4, capacity=6, population=4),
              resume=str(tmp_path / "hunt_g1.json"), generations=3)
    with pytest.raises(ScenarioError, match="outside hunt"):
        _hunt(resume=str(tmp_path / "hunt_g3.json"), generations=3)


@pytest.mark.parametrize("kw, match", [
    (dict(space=SPACE, generations=0), "generations"),
    (dict(space=SPACE, checkpoint_every=2), "checkpoint_path"),
    (dict(), "needs a search space"),
    (dict(space=SPACE, objective="win"), "unknown search objective"),
    (dict(space=generate.SearchSpace(rounds=4, capacity=6, population=5),
          mesh=make_mesh((2, 1), devices=["cpu", "cpu"])), "does not divide"),
])
def test_hunt_eager_validation(kw, match):
    with pytest.raises(ScenarioError, match=match):
        _hunt(**kw)


def test_search_depth_k_dispatches_without_waiting(monkeypatch):
    """The dispatch-count proof with the search harness live: one
    population keeps depth + 1 dispatches in flight, and retire d comes
    after dispatch d + depth; nothing in the loop waits on a device."""
    def _forbidden(*a, **k):
        raise AssertionError("the search waited on the device")

    monkeypatch.setattr(torch.cuda, "synchronize", _forbidden)
    events = []

    def seam(call, phase, d, lo, hi):
        events.append((phase, d))
        return call()

    rounds, depth = 7, 3
    space = generate.SearchSpace(rounds=rounds, capacity=6, population=8, events_min=2,
                                 events_max=5)
    pop = generate.sample_population(space, seed=3)
    loop.evaluate_population(
        loop.candidate_keys(3, list(range(8))), loop.population_state(8, 6, "attack", CPU),
        generate.lower_population(pop, 6, rounds), rounds=rounds, depth=depth,
        rounds_per_dispatch=1, exec_seam=seam, device=CPU)
    assert [d for p, d in events if p == "dispatch"] == list(range(rounds))
    assert [d for p, d in events if p == "retire"] == list(range(rounds))
    first = events.index(("retire", 0))
    assert events[:first] == [("dispatch", i) for i in range(depth + 1)]
    for r in range(rounds - depth):
        assert events.index(("retire", r)) > events.index(("dispatch", r + depth))


def test_mesh_hunt_equals_one_device():
    plain = _hunt(space=SPACE, seed=3, generations=2, minimize=False)
    sharded = _hunt(space=SPACE, seed=3, generations=2, minimize=False,
                    mesh=make_mesh((2, 1), devices=["cpu", "cpu"]))
    for key in ("found", "elites", "state"):
        assert sharded[key] == plain[key]
    assert sharded["stats"]["shards"] == 2
    _same_hunt(plain, _j_hunt_cached(3, 2, 0))


def test_committed_reproducers_meet_the_recomputed_oracle():
    """Each committed reproducer's counters as the reference's
    ``evaluate_alone(engine="xla")`` computes them today; the port's
    ``evaluate_alone`` meets them bit for bit, decisions and leaders
    too, and the corpus contract accepts every file."""
    from ba_tpu.scenario.spec import load as j_load

    specs = corpus.load_corpus(corpus.FOUND_DIR)
    assert len(specs) >= 2 and pathlib.Path(corpus.FOUND_DIR) == \
        REPO / "examples" / "scenarios" / "found"
    for spec in specs:
        corpus.check_reproducer(spec)
        pr = spec.provenance["search"]
        ours = loop.evaluate_alone(spec, seed=pr["seed"], uid=pr["uid"],
                                   capacity=pr["capacity"], device=CPU)
        want = j_loop.evaluate_alone(
            j_load(os.path.join(corpus.FOUND_DIR, f"{spec.name}.json")), seed=pr["seed"],
            uid=pr["uid"], capacity=pr["capacity"], engine="xla")
        assert objective.counters_dict(ours["counters"], ours["counter_names"]) == \
            j_obj.counters_dict(np.asarray(want["counters"]), want["counter_names"]), spec.name
        np.testing.assert_array_equal(ours["decisions"], np.asarray(want["decisions"]))
        np.testing.assert_array_equal(ours["leaders"], np.asarray(want["leaders"]))
        assert set(objective.counters_dict(ours["counters"], ours["counter_names"])) == \
            set(pr["counters"])
        assert objective.violation_rows(ours["counters"][None, :], ours["counter_names"],
                                        pr["objective"])[0], spec.name


def test_shrink_refuses_a_non_finding_and_the_oracle_matches_the_reference():
    from ba_tpu.search import minimize as j_minimize

    names = ("quorum_failures", "unanimous_rounds", "equivocation_observed",
             "ic1_violations", "ic2_violations")
    quiet = generate.sample_campaign(SPACE, 3, 0)
    with pytest.raises(ScenarioError, match="nothing to shrink"):
        minimize.shrink(quiet, seed=3, uid=0, capacity=6,
                        evaluate=lambda c: {"counters": np.zeros(5, np.int32),
                                            "counter_names": names})
    verdict = minimize.verify_minimized(quiet, seed=3, uid=0, capacity=6, device=CPU)
    assert verdict == j_minimize.verify_minimized(j_gen.sample_campaign(J_SPACE, 3, 0), seed=3,
                                                  uid=0, capacity=6, engine="xla")
    assert verdict["bit_exact"] is True


def test_cluster_run_search_and_the_repl_match_the_reference(tmp_path):
    path = tmp_path / "space.json"
    path.write_text(json.dumps(DOC))
    cluster = Cluster(4, TorchBackend(device="cpu"), seed=0)
    jc = JCluster(4, j_backends.JaxBackend(platform="cpu"), seed=0)
    script = [f"search gens=1 objective=quorum space={path}",
              f"search gens=2 space={path} export={tmp_path / 'out'}",
              "search gens=zero", "search objective=win", "search nope",
              f"search space={tmp_path / 'missing.json'}", "search gens=0"]
    ours, theirs = [], []
    for line in script:
        handle_command(cluster, line, ours.append)
        j_handle(jc, line.replace("/out", "/j_out"), theirs.append)
    assert [ln.replace("/j_out", "/out") for ln in theirs] == ours
    assert any(ln.startswith("Search found:") for ln in ours)
    assert len(cluster.generals) == 4
    res = cluster.run_search(space=SPACE, generations=1, minimize=False)
    assert res["stats"]["campaigns"] == SPACE.population
    # the default space: capacity from the padded roster, 32 candidates
    res = cluster.run_search(generations=1, minimize=False)
    assert res["stats"]["campaigns"] == 32 and res["state"]["space_doc"]["capacity"] == 4
    quiet = []
    handle_command(Cluster(4, PyBackend(), seed=0), "search gens=1", quiet.append)
    assert quiet == []
    sm = Cluster(4, TorchBackend(device="cpu", protocol="sm"), seed=0)
    assert sm.run_search(space=SPACE, generations=1) is None
