"""The adversary hunt loop (``ba_tpu/search/loop.py``): random sweep ->
elite selection -> mutation, batched campaign-per-instance through the
coalesced engine.

One generation is one population of B candidate campaigns lowered into a
single batch (``generate.lower_population``) and evaluated by one
``coalesced_sweep(scenario=...)`` stream: on the card, K1's slot mode with
scenario planes.  Per-slot key schedules make candidate ``b``'s decisions,
leaders and counters bit-identical to its own B = 1 run (the serving parity
pin, reused as the search's oracle), and the per-slot counter rows that
the engine's depth-delayed retires fetch anyway are all that scoring
reads (``objective.score_rows``): the hunt adds no wait on the card.

Candidate ``uid`` draws its key as ``fold_in(key(seed), uid)``
(``core/rng.py``, the reference's threefry): slot-position-free, so
population membership, mesh entry and standalone replay agree bit for
bit, and with the reference's hunt on the same space and seed.

Search state is plain JSON, checkpointed through
``utils/snapshot.write_search_checkpoint`` (the reference's format): a
killed hunt resumes bit-exactly in either package, and the resumed hunt
re-derives or inherits the same run id.

``mesh=`` (a ``parallel.mesh.Mesh``) splits a generation into per-entry
sub-populations, one thread an entry, each calling ``coalesced_sweep``
with that entry's device; rows concatenate in entry order, so a sharded
hunt equals the one-device hunt at any entry count.

Importing this module loads no torch: the engine loads in the function
bodies.
"""

from __future__ import annotations

import dataclasses
import json
import time

from ba_tpu_torch import obs
from ba_tpu_torch.scenario.spec import Scenario, ScenarioError, from_dict, to_dict
from ba_tpu_torch.search import generate as _generate
from ba_tpu_torch.search import objective as _objective
from ba_tpu_torch.utils import metrics as _metrics

# Pad slots (the minimizer's co-population) fold uids from here up, far
# above any hunt's candidate cursor, so a pad key never collides with a
# candidate's stream.
PAD_UID_BASE = 0x7F000000


def candidate_keys(seed: int, uids):
    """The candidates' key data, one row each: ``fold_in(key(seed), uid)``
    as an int64 ``[len(uids), 2]`` tensor on the CPU (``coalesced_sweep``
    moves it).  Slot-position-free: the same key drives a candidate in any
    population, any mesh entry and its standalone replay."""
    import torch

    from ba_tpu_torch.core import rng

    uids = torch.tensor([int(u) for u in uids], dtype=torch.int64)
    return rng.fold_in(rng.key(seed, "cpu"), uids)


def population_state(batch: int, capacity: int, order: str, device=None):
    """The all-honest initial state every candidate starts from, on
    ``device`` (the card unless given): every slot alive, nobody faulty,
    slot 0 leads, ids 1..capacity.  The campaign's events are the whole
    adversary, so a candidate is a pure function of (events, seed, uid)."""
    from ba_tpu_torch.core.state import make_state
    from ba_tpu_torch.core.types import ATTACK, RETREAT

    code = {"attack": ATTACK, "retreat": RETREAT}[order]
    return make_state(batch, capacity, order=code, device=device)


def evaluate_population(  # ba-lint: donates(state)
    slot_keys,
    state,
    block,
    *,
    rounds: int,
    depth: int = 2,
    rounds_per_dispatch: int = 8,
    engine: str | None = None,
    exec_seam=None,
    device=None,
):
    """One population block through ``coalesced_sweep(scenario=block)``:
    the one evaluation path of the hunt, the minimizer and the tests.
    ``state`` is consumed (the engine updates it in place): stage a fresh
    :func:`population_state` a call.  Returns the coalesced result dict:
    ``decisions`` [rounds, B], ``leaders`` [rounds, B], ``counters`` [B,
    C] and ``counter_names``, ``stats``."""
    from ba_tpu_torch.parallel.pipeline import coalesced_sweep

    return coalesced_sweep(
        slot_keys, state, rounds, scenario=block, depth=depth,
        rounds_per_dispatch=rounds_per_dispatch, engine=engine, exec_seam=exec_seam,
        device=device,
    )


def _mesh_devices(mesh) -> list:
    """A Mesh (or any device sequence) as its entries' devices, in entry
    order."""
    devices = getattr(mesh, "devices", mesh)
    flat = getattr(devices, "flat", None)
    return list(flat) if flat is not None else list(devices)


def _evaluate_candidates(candidates, uids, space, *, seed, depth, rounds_per_dispatch,
                         engine, exec_seam, device, mesh=None, timing=None):
    """Lower and evaluate a candidate list; with ``mesh`` the population
    splits into per-entry sub-populations, one thread an entry.  Returns
    ``(counters [B, C], counter_names, decisions [R, B], leaders [R, B],
    stats)`` in candidate order, bit-identical at any entry count.
    ``timing``, a dict, accumulates the host lowering's wall under
    ``lower_s``."""
    import numpy as np

    def run_shard(cands, cand_uids, dev):
        t0 = time.perf_counter()
        block = _generate.lower_population(cands, space.capacity, space.rounds)
        if timing is not None:
            timing["lower_s"] = timing.get("lower_s", 0.0) + time.perf_counter() - t0
        state = population_state(len(cands), space.capacity, space.order, dev)
        return evaluate_population(
            candidate_keys(seed, cand_uids), state, block, rounds=space.rounds,
            depth=depth, rounds_per_dispatch=rounds_per_dispatch, engine=engine,
            exec_seam=exec_seam, device=dev,
        )

    if mesh is None:
        res = run_shard(candidates, uids, device)
        return (res["counters"], res["counter_names"], res["decisions"], res["leaders"],
                [res["stats"]])
    devices = _mesh_devices(mesh)
    d = len(devices)
    if d < 1 or len(candidates) % d:
        raise ScenarioError(
            f"population {len(candidates)} does not divide over {d} mesh device(s) — "
            f"per-shard populations must be equal")
    per = len(candidates) // d
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=d) as pool:
        futures = [
            pool.submit(run_shard, candidates[k * per:(k + 1) * per],
                        uids[k * per:(k + 1) * per], devices[k])
            for k in range(d)
        ]
        shards = [f.result() for f in futures]  # entry order, not completion order
    return (
        np.concatenate([s["counters"] for s in shards], axis=0),
        shards[0]["counter_names"],
        np.concatenate([s["decisions"] for s in shards], axis=1),
        np.concatenate([s["leaders"] for s in shards], axis=1),
        [s["stats"] for s in shards],
    )


def evaluate_alone(
    campaign: Scenario,
    *,
    seed: int,
    uid: int,
    capacity: int,
    depth: int = 2,
    rounds_per_dispatch: int = 8,
    engine: str | None = None,
    device=None,
):
    """One candidate alone at B = 1: the standalone leg of the parity
    oracle (same key, same padded capacity as its population run).
    Returns ``{counters [C], counter_names, decisions [R], leaders
    [R]}``."""
    block = _generate.lower_population([campaign], capacity, campaign.rounds)
    state = population_state(1, capacity, campaign.order, device)
    res = evaluate_population(
        candidate_keys(seed, [uid]), state, block, rounds=campaign.rounds, depth=depth,
        rounds_per_dispatch=rounds_per_dispatch, engine=engine, device=device,
    )
    return {
        "counters": res["counters"][0],
        "counter_names": res["counter_names"],
        "decisions": res["decisions"][:, 0],
        "leaders": res["leaders"][:, 0],
    }


@dataclasses.dataclass
class SearchState:
    """The hunt's resumable cursor, plain JSON data.

    ``generation`` is the next generation to run and ``next_uid`` the
    next candidate uid; with the seed-keyed generator they determine
    every later sample and mutation, which is why a resume is bit-exact.
    """

    seed: int
    objective: str
    space_doc: dict
    generation: int = 0
    next_uid: int = 0
    elites: list = dataclasses.field(default_factory=list)
    found: list = dataclasses.field(default_factory=list)
    campaigns: int = 0
    best_score: int = 0

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "SearchState":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - fields
        if unknown:
            raise ScenarioError(f"unknown search state keys: {sorted(unknown)}")
        return cls(**doc)


def _compose_population(state: SearchState, space, elites: int):
    """The next generation's candidates: surviving elites spawn mutants
    for half the population, fresh samples fill the rest (generation 0,
    or a hunt without elites, is the pure random sweep).  Assigns uids
    from the state's cursor."""
    parents = [from_dict(e["doc"]) for e in state.elites[:elites]]
    candidates, uids = [], []

    def add(campaign):
        candidates.append(campaign)
        uids.append(state.next_uid)
        state.next_uid += 1

    n_mutants = space.population // 2 if parents else 0
    for j in range(n_mutants):
        add(_generate.mutate_campaign(parents[j % len(parents)], space, state.seed,
                                      state.next_uid))
    while len(candidates) < space.population:
        add(_generate.sample_campaign(space, state.seed, state.next_uid))
    return candidates, uids


def _write_checkpoint(path, state: SearchState, run_id) -> str:
    from ba_tpu_torch.utils import snapshot as _snapshot

    written = path.replace("{generation}", str(state.generation))
    _snapshot.write_search_checkpoint(written, state.to_doc(), run_id=run_id)
    _metrics.emit({
        "event": "search_checkpoint",
        "v": _metrics.SCHEMA_VERSION,
        "generation": state.generation,
        "path": written,
        "found": len(state.found),
    })
    obs.default_registry().counter("search_checkpoints_total").inc()
    return written


def _validate_dials(generations, elites, depth, rounds_per_dispatch, stop_after,
                    minimize_max, checkpoint_every, checkpoint_path):
    if generations < 1:
        raise ScenarioError(f"generations={generations} must be >= 1")
    if elites < 0:
        raise ScenarioError(f"elites={elites} must be >= 0")
    if depth < 1 or rounds_per_dispatch < 1:
        raise ScenarioError(f"depth={depth} / rounds_per_dispatch={rounds_per_dispatch} "
                            f"must all be >= 1")
    if stop_after is not None and stop_after < 1:
        raise ScenarioError(f"stop_after={stop_after} must be >= 1")
    if minimize_max < 0:
        raise ScenarioError(f"minimize_max={minimize_max} must be >= 0")
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ScenarioError(f"checkpoint_every={checkpoint_every} must be >= 1")
    if checkpoint_every is not None and checkpoint_path is None:
        raise ScenarioError("checkpoint_every needs checkpoint_path")


def _resume_state(resume, space):
    """``(state, space, inherited run id)`` from a checkpoint path or a
    state doc; a given ``space`` must equal the checkpoint's."""
    if isinstance(resume, str):
        from ba_tpu_torch.utils import snapshot as _snapshot

        meta, state_doc = _snapshot.read_search_checkpoint(resume)
        inherited = meta.get("run_id")
    else:
        state_doc, inherited = dict(resume), None
    state = SearchState.from_doc(state_doc)
    resumed_space = _generate.space_from_dict(state.space_doc)
    if space is not None:
        given = _generate.space_to_dict(
            space if isinstance(space, _generate.SearchSpace)
            else _generate.space_from_dict(space))
        if given != state.space_doc:
            raise ScenarioError(
                "resume checkpoint was written for a different search space — pass "
                "space=None (the checkpoint carries it) or the identical space")
    return state, resumed_space, inherited


def _minimize_found(state, space, obj, *, seed, minimize_max, depth, rounds_per_dispatch,
                    engine, device):
    from ba_tpu_torch.search import minimize as _minimize

    minimized = []
    for entry in state.found[:minimize_max]:
        dials = dict(seed=seed, uid=entry["uid"], capacity=space.capacity, objective=obj,
                     depth=depth, rounds_per_dispatch=rounds_per_dispatch, engine=engine,
                     device=device)
        shrunk, info = _minimize.shrink(from_dict(entry["doc"]), **dials)
        verdict = _minimize.verify_minimized(shrunk, **dials)
        minimized.append({
            "doc": to_dict(shrunk),
            "uid": entry["uid"],
            "generation": entry["generation"],
            "events_before": info["events_before"],
            "events_after": info["events_after"],
            "evals": info["evals"],
            "score": verdict["score"],
            "counters": verdict["counters"],
            "bit_exact": verdict["bit_exact"],
        })
        _metrics.emit({
            "event": "search_minimized",
            "v": _metrics.SCHEMA_VERSION,
            "name": shrunk.name,
            "uid": entry["uid"],
            "generation": entry["generation"],
            "events_before": info["events_before"],
            "events_after": info["events_after"],
            "evals": info["evals"],
            "score": verdict["score"],
            "bit_exact": verdict["bit_exact"],
            "objective": obj.name,
        })
    return minimized


def hunt(
    space=None,
    *,
    seed: int = 0,
    generations: int = 4,
    objective="ic",
    elites: int = 4,
    depth: int = 2,
    rounds_per_dispatch: int = 8,
    mesh=None,
    engine: str | None = None,
    exec_seam=None,
    device=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int | None = None,
    resume=None,
    stop_after: int | None = None,
    minimize: bool = True,
    minimize_max: int = 4,
    export_dir: str | None = None,
    on_generation=None,
):
    """Run an adversary hunt: ``generations`` rounds of sample, evaluate,
    select and mutate over ``space``, collecting every campaign that
    breaks the ``objective``'s violation counters.

    ``space`` is a :class:`~ba_tpu_torch.search.generate.SearchSpace` (or
    its dict form); every dial is validated before any tensor is made.
    ``device`` is the card unless given; ``engine`` follows
    ``coalesced_sweep`` (``"cuda"``, K1, on the card by default).
    ``checkpoint_path`` (with ``checkpoint_every`` generations, default 1)
    writes the search state after each due generation, a literal
    ``{generation}`` keeping a family; ``resume=`` (a path or a state doc)
    continues a hunt bit-exactly (``space`` / ``seed`` / ``objective``
    ride the checkpoint; a conflicting ``space`` raises).
    ``stop_after=N`` ends the generation loop once N distinct violations
    are on file.  ``minimize=True`` shrinks up to ``minimize_max``
    findings (``search/minimize.py``), each checked by the alone vs
    in-population oracle; ``export_dir`` writes them as provenance-stamped
    scenario specs (``search/corpus.py``).  ``on_generation(g, info)`` is
    called after each generation.

    The hunt runs in a run scope whose id is derived from seed, space,
    objective and generations (the reference's material), or inherited
    from the resume checkpoint.

    Returns a dict: ``found``, ``minimized``, ``elites``, ``exported``,
    ``state`` (the final resumable doc) and ``stats`` (``lower_s``: the
    host lowering's wall over all generations).
    """
    obj = _objective.get_objective(objective)
    _validate_dials(generations, elites, depth, rounds_per_dispatch, stop_after, minimize_max,
                    checkpoint_every, checkpoint_path)
    if checkpoint_path is not None and checkpoint_every is None:
        checkpoint_every = 1

    if resume is not None:
        state, space, inherited_rid = _resume_state(resume, space)
        seed = state.seed
        obj = _objective.get_objective(state.objective)
        if not state.generation < generations:
            raise ScenarioError(
                f"resume cursor {state.generation} outside hunt [0, {generations}) — pass "
                f"a larger generations= to extend the hunt")
    else:
        if space is None:
            raise ScenarioError("hunt needs a search space (or resume=)")
        if not isinstance(space, _generate.SearchSpace):
            space = _generate.space_from_dict(space)
        _generate.validate_space(space)
        state = SearchState(seed=seed, objective=obj.name,
                            space_doc=_generate.space_to_dict(space))
        inherited_rid = None
    if mesh is not None:
        d = len(_mesh_devices(mesh))
        if d < 1 or space.population % d:
            raise ScenarioError(
                f"population {space.population} does not divide over {d} mesh device(s) "
                f"— per-shard populations must be equal")
    else:
        from ba_tpu_torch.core.state import resolve_device

        device = resolve_device(device)

    rid = obs.flight.resolve_run_id(
        inherited=inherited_rid,
        material_fn=lambda: ["search", seed, json.dumps(state.space_doc, sort_keys=True),
                             obj.name, generations],
    )
    reg = obs.default_registry()
    seen = {_generate.campaign_fingerprint(from_dict(e["doc"])) for e in state.found}
    n_checkpoints = 0
    shard_stats = []
    timing = {"lower_s": 0.0}
    t_hunt = time.perf_counter()
    with obs.flight.run_scope(rid) as scope:
        obs.instant("search_start", generations=generations, population=space.population,
                    objective=obj.name, resume=state.generation)
        while state.generation < generations:
            if stop_after is not None and len(state.found) >= stop_after:
                break
            g = state.generation
            t0 = time.perf_counter()
            candidates, uids = _compose_population(state, space, elites)
            rows, names, _, _, shard_stats = _evaluate_candidates(
                candidates, uids, space, seed=seed, depth=depth,
                rounds_per_dispatch=rounds_per_dispatch, engine=engine,
                exec_seam=exec_seam, device=device, mesh=mesh, timing=timing,
            )
            scores = _objective.score_rows(rows, names, obj)
            violations = _objective.violation_rows(rows, names, obj)
            new_found = 0
            for i, campaign in enumerate(candidates):
                if not violations[i]:
                    continue
                fp = _generate.campaign_fingerprint(campaign)
                if fp in seen:
                    continue
                seen.add(fp)
                new_found += 1
                entry = {
                    "doc": to_dict(campaign),
                    "uid": uids[i],
                    "generation": g,
                    "score": int(scores[i]),
                    "counters": _objective.counters_dict(rows[i], names),
                }
                state.found.append(entry)
                _metrics.emit({
                    "event": "search_found",
                    "v": _metrics.SCHEMA_VERSION,
                    "name": campaign.name,
                    "uid": uids[i],
                    "generation": g,
                    "score": entry["score"],
                    "events": len(campaign.events),
                    "counters": entry["counters"],
                    "objective": obj.name,
                })
            pool = state.elites[:elites] + [
                {"doc": to_dict(c), "uid": uids[i], "score": int(scores[i])}
                for i, c in enumerate(candidates)
            ]
            pool.sort(key=lambda e: (-e["score"], e["uid"]))
            state.elites = pool[: max(elites, 1)]
            state.campaigns += len(candidates)
            state.best_score = max(state.best_score, int(scores.max()) if len(scores) else 0)
            state.generation = g + 1
            reg.counter("search_generations_total").inc()
            reg.counter("search_campaigns_total").inc(len(candidates))
            if new_found:
                reg.counter("search_found_total").inc(new_found)
            reg.gauge("search_best_score").set(state.best_score)
            _metrics.emit({
                "event": "search_generation",
                "v": _metrics.SCHEMA_VERSION,
                "generation": g,
                "campaigns": len(candidates),
                "best_score": state.best_score,
                "new_found": new_found,
                "found_total": len(state.found),
                "objective": obj.name,
                "wall_s": round(time.perf_counter() - t0, 6),
            })
            if on_generation is not None:
                on_generation(g, {"scores": scores, "new_found": new_found,
                                  "found_total": len(state.found)})
            if checkpoint_path is not None and (state.generation % checkpoint_every == 0
                                                or state.generation == generations):
                _write_checkpoint(checkpoint_path, state, scope.run_id)
                n_checkpoints += 1

        minimized = []
        if minimize:
            minimized = _minimize_found(
                state, space, obj, seed=seed, minimize_max=minimize_max, depth=depth,
                rounds_per_dispatch=rounds_per_dispatch, engine=engine,
                device=device if mesh is None else _mesh_devices(mesh)[0])

        exported = []
        if export_dir is not None and minimized:
            from ba_tpu_torch.search import corpus as _corpus

            exported = _corpus.export_found(minimized, export_dir, seed=seed,
                                            objective=obj.name, capacity=space.capacity)
        reg.gauge("search_corpus_size").set(len(exported))
        obs.instant("search_drain", generations=state.generation, found=len(state.found),
                    best_score=state.best_score)
        result = {
            "found": list(state.found),
            "minimized": minimized,
            "elites": list(state.elites),
            "exported": exported,
            "state": state.to_doc(),
            "stats": {
                "run_id": scope.run_id,
                "seed": seed,
                "objective": obj.name,
                "generations_run": state.generation,
                "population": space.population,
                "campaigns": state.campaigns,
                "found": len(state.found),
                "minimized": len(minimized),
                "best_score": state.best_score,
                "checkpoints": n_checkpoints,
                "shards": len(_mesh_devices(mesh)) if mesh is not None else 1,
                "engine": shard_stats[0].get("engine") if shard_stats else None,
                "lower_s": round(timing["lower_s"], 6),
                "wall_s": round(time.perf_counter() - t_hunt, 6),
            },
        }
        if scope.owner:
            obs.flight.emit_flight_summary(run_id=scope.run_id)
    return result
