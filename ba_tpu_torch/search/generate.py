"""Campaign generator: seed-keyed sampling + mutation over the scenario
spec grammar, lowered campaign-per-instance into one batched block.

The port's own copy of ``ba_tpu/search/generate.py``.

A
candidate adversary campaign IS an ordinary validated
:class:`~ba_tpu_torch.scenario.spec.Scenario` — the same plain-data grammar
the REPL replays and CI round-trips — so anything the search finds is
immediately a committable, replayable spec file.  A *population* of B
distinct candidates lowers into ONE
:class:`~ba_tpu_torch.scenario.compile.SparseScenarioBlock` of batch B by
tagging candidate ``i``'s resolved events with ``instances=(i,)`` (the
per-instance masks of the scenario engine), so
evaluating B campaigns costs exactly one batched dispatch stream.

Everything here is deterministic and seed-keyed: candidate ``uid``
draws its events from ``numpy`` ``default_rng((seed, tag, uid))`` —
``SeedSequence`` spawning, stable across processes — so the same
``(seed, uid)`` always yields the same campaign, which is what makes
search-state checkpoints resumable bit-exactly and exported
reproducers self-describing (their provenance stores the pair).

Constraints are plain data (:class:`SearchSpace`) and validated
EAGERLY, ``coalesced_sweep``-style: population size, event budgets,
strategy names, and the n/f knobs (``faulty_max`` / ``kill_max``) all
raise :class:`~ba_tpu_torch.scenario.spec.ScenarioError`-grade messages
before any array is built — a hand-edited search config fails at
``validate_space``, never mid-hunt with a shape crash.

Like ``scenario/spec.py`` this module is numpy/stdlib only (no torch):
the ``python -m ba_tpu_torch.search`` sample/corpus subcommands rely on
that import.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ba_tpu_torch.scenario.compile import SparseScenarioBlock, compile_scenario
from ba_tpu_torch.scenario.spec import (
    EVENT_KINDS,
    ORDERS,
    STRATEGY_NAMES,
    Event,
    Scenario,
    ScenarioError,
    validate,
)

# Default event-kind menu: `revive` is excluded — on the all-alive
# initial population state a revive is a no-op until a kill lands, and
# the kill/revive same-round conflict rule would force resampling;
# spaces that want membership-flap campaigns opt it back in.
DEFAULT_KINDS = ("kill", "set_faulty", "set_strategy")

# rng stream tags: one namespace per derivation so a sampled candidate
# and a mutation of the same uid can never share a stream.
_TAG_SAMPLE = 0
_TAG_MUTATE = 1


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The search's constraint set, as plain data.

    - ``rounds`` / ``capacity``: every candidate campaign's length and
      cluster width (slots 1..capacity, the generator's roster);
    - ``population``: candidates per generation — B campaigns per
      batched dispatch stream;
    - ``events_min`` / ``events_max``: per-candidate event budget;
    - ``kinds``: the event-kind menu (subset of ``EVENT_KINDS``);
    - ``strategies``: the adversary-strategy menu ``set_strategy`` may
      assign (subset of ``STRATEGY_NAMES``);
    - ``faulty_max`` / ``kill_max``: n/f knobs — the most DISTINCT
      generals a single campaign may ever set faulty / kill (None = no
      cap).  ``faulty_max <= floor((capacity - 1) / 3)`` keeps the hunt
      inside the classical n > 3t bound, where a violation would
      falsify the protocol; the default (None) hunts the full space;
    - ``ids_per_event``: most generals one event may name;
    - ``order``: the campaign order every candidate runs under.
    """

    rounds: int
    capacity: int
    population: int
    events_min: int = 1
    events_max: int = 6
    kinds: tuple = DEFAULT_KINDS
    strategies: tuple = STRATEGY_NAMES
    faulty_max: int | None = None
    kill_max: int | None = None
    ids_per_event: int = 3
    order: str = "attack"


def validate_space(space: SearchSpace) -> SearchSpace:
    """Eager host-side validation; returns ``space`` for chaining.

    Everything a hand-edited config could get wrong raises HERE with a
    ScenarioError naming the field — before any candidate samples, any
    plane materializes, or any buffer donates (the
    ``coalesced_sweep``-style eager-validation discipline)."""
    for name in ("rounds", "capacity", "population"):
        v = getattr(space, name)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ScenarioError(
                f"search space {name}={v!r} must be an int >= 1"
            )
    for name in ("events_min", "events_max", "ids_per_event"):
        v = getattr(space, name)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ScenarioError(
                f"search space {name}={v!r} must be an int >= 0"
            )
    if space.events_min > space.events_max:
        raise ScenarioError(
            f"search space events_min={space.events_min} exceeds "
            f"events_max={space.events_max}"
        )
    if space.events_max > space.rounds * space.capacity:
        raise ScenarioError(
            f"search space events_max={space.events_max} exceeds the "
            f"campaign's {space.rounds} x {space.capacity} event cells"
        )
    if space.ids_per_event < 1 or space.ids_per_event > space.capacity:
        raise ScenarioError(
            f"search space ids_per_event={space.ids_per_event} outside "
            f"[1, capacity={space.capacity}]"
        )
    if not space.kinds or not set(space.kinds) <= set(EVENT_KINDS):
        raise ScenarioError(
            f"search space kinds={space.kinds!r} must be a non-empty "
            f"subset of {EVENT_KINDS}"
        )
    if not space.strategies or not set(space.strategies) <= set(
        STRATEGY_NAMES
    ):
        raise ScenarioError(
            f"search space strategies={space.strategies!r} must be a "
            f"non-empty subset of {STRATEGY_NAMES}"
        )
    for name in ("faulty_max", "kill_max"):
        v = getattr(space, name)
        if v is not None and (
            not isinstance(v, int) or isinstance(v, bool)
            or not 0 <= v <= space.capacity
        ):
            raise ScenarioError(
                f"search space {name}={v!r} must be None or an int in "
                f"[0, capacity={space.capacity}]"
            )
    if space.order not in ORDERS:
        raise ScenarioError(
            f"search space order={space.order!r} must be one of {ORDERS}"
        )
    return space


def space_to_dict(space: SearchSpace) -> dict:
    """The JSON form (round-trips exactly through :func:`space_from_dict`)."""
    doc = dataclasses.asdict(validate_space(space))
    doc["kinds"] = list(space.kinds)
    doc["strategies"] = list(space.strategies)
    return doc


def space_from_dict(doc: dict) -> SearchSpace:
    """Parse + validate the JSON form; strict about keys."""
    if not isinstance(doc, dict):
        raise ScenarioError(
            f"search space document must be an object, got {doc!r}"
        )
    fields = {f.name for f in dataclasses.fields(SearchSpace)}
    unknown = set(doc) - fields
    if unknown:
        raise ScenarioError(f"unknown search space keys: {sorted(unknown)}")
    missing = {"rounds", "capacity", "population"} - set(doc)
    if missing:
        raise ScenarioError(
            f"search space document missing keys: {sorted(missing)}"
        )
    kwargs = dict(doc)
    for name in ("kinds", "strategies"):
        if name in kwargs:
            if not isinstance(kwargs[name], (list, tuple)):
                raise ScenarioError(
                    f"search space {name} must be a list, "
                    f"got {kwargs[name]!r}"
                )
            kwargs[name] = tuple(kwargs[name])
    return validate_space(SearchSpace(**kwargs))


def candidate_name(seed: int, uid: int) -> str:
    """The canonical candidate name: seed + uid IS the replay recipe
    (the per-slot PRNG key derives from exactly this pair)."""
    return f"search-s{seed}-u{uid}"


def _rng(seed: int, tag: int, uid: int) -> np.random.Generator:
    """One deterministic stream per (seed, namespace, uid) — numpy's
    SeedSequence mixing, stable across processes and platforms."""
    return np.random.default_rng((seed, tag, uid))


def _draw_ids(rng, space: SearchSpace, pool: list) -> tuple:
    k = min(1 + int(rng.integers(space.ids_per_event)), len(pool))
    picked = rng.choice(len(pool), size=k, replace=False)
    return tuple(sorted(int(pool[i]) for i in picked))


def _draw_events(rng, space: SearchSpace) -> tuple:
    """Sample one candidate's event list under the space's budgets.

    Budgets are enforced DURING sampling (the faulty/kill id pools
    shrink as a campaign spends them), so every sampled candidate
    validates by construction — no rejection loop whose iteration count
    could couple distinct uids' streams."""
    n_events = int(
        rng.integers(space.events_min, space.events_max + 1)
    )
    all_ids = list(range(1, space.capacity + 1))
    faulty_pool = list(all_ids)
    kill_pool = list(all_ids)
    faulty_budget = (
        space.capacity if space.faulty_max is None else space.faulty_max
    )
    kill_budget = (
        space.capacity if space.kill_max is None else space.kill_max
    )
    killed_by_round: dict = {}
    revived_by_round: dict = {}
    events = []
    for _ in range(n_events):
        kind = space.kinds[int(rng.integers(len(space.kinds)))]
        rnd = int(rng.integers(space.rounds))
        if kind == "kill":
            # Same-round kill+revive of one general is the one grammar
            # conflict validate() rejects — exclude ids this candidate
            # already revives in this round (the mirror of the revive
            # branch's exclusion; either event may sample first).
            pool = [
                g for g in kill_pool[: max(kill_budget, 0)]
                if g not in revived_by_round.get(rnd, ())
            ]
            if not pool:
                continue
            ids = _draw_ids(rng, space, pool)
            kill_budget -= sum(1 for g in ids if g in kill_pool)
            kill_pool = [g for g in kill_pool if g not in ids]
            killed_by_round.setdefault(rnd, set()).update(ids)
            events.append(Event(round=rnd, kind="kill", ids=ids))
        elif kind == "revive":
            pool = [
                g for g in all_ids
                if g not in killed_by_round.get(rnd, ())
            ]
            if not pool:
                continue
            ids = _draw_ids(rng, space, pool)
            revived_by_round.setdefault(rnd, set()).update(ids)
            events.append(Event(round=rnd, kind="revive", ids=ids))
        elif kind == "set_faulty":
            # Bias 3:1 toward True: clearing fault flags on an honest
            # roster is mostly a no-op, and the hunt wants adversaries.
            value = bool(rng.integers(4) > 0)
            if value:
                pool = faulty_pool[: max(faulty_budget, 0)]
                if not pool:
                    continue
                ids = _draw_ids(rng, space, pool)
                faulty_budget -= sum(1 for g in ids if g in faulty_pool)
                faulty_pool = [g for g in faulty_pool if g not in ids]
            else:
                ids = _draw_ids(rng, space, all_ids)
            events.append(
                Event(round=rnd, kind="set_faulty", ids=ids, value=value)
            )
        else:  # set_strategy (validate_space rejected everything else)
            strat = space.strategies[
                int(rng.integers(len(space.strategies)))
            ]
            ids = _draw_ids(rng, space, all_ids)
            events.append(
                Event(
                    round=rnd, kind="set_strategy", ids=ids, value=strat
                )
            )
    return tuple(events)


def sample_campaign(space: SearchSpace, seed: int, uid: int) -> Scenario:
    """One deterministic candidate campaign for ``(seed, uid)``."""
    rng = _rng(seed, _TAG_SAMPLE, uid)
    return validate(
        Scenario(
            name=candidate_name(seed, uid),
            rounds=space.rounds,
            events=_draw_events(rng, space),
            order=space.order,
        )
    )


def mutate_campaign(
    parent: Scenario, space: SearchSpace, seed: int, uid: int
) -> Scenario:
    """A deterministic single-step mutation of ``parent`` — the
    coordinate-descent move over event planes.

    One of: drop an event, re-round an event (move it along the round
    axis), re-value a ``set_strategy``/``set_faulty`` event, or append
    a freshly sampled event (budget-checked by revalidating the whole
    child against the space's budgets; an over-budget or conflicting
    child falls back to a fresh sample so the move never dead-ends).
    The child is keyed by its OWN uid — resuming a checkpoint replays
    identical mutations.
    """
    rng = _rng(seed, _TAG_MUTATE, uid)
    events = list(parent.events)
    op = int(rng.integers(4))
    if op == 0 and events:
        events.pop(int(rng.integers(len(events))))
    elif op == 1 and events:
        i = int(rng.integers(len(events)))
        events[i] = dataclasses.replace(
            events[i], round=int(rng.integers(space.rounds))
        )
    elif op == 2 and events:
        i = int(rng.integers(len(events)))
        ev = events[i]
        if ev.kind == "set_strategy":
            events[i] = dataclasses.replace(
                ev,
                value=space.strategies[
                    int(rng.integers(len(space.strategies)))
                ],
            )
        elif ev.kind == "set_faulty":
            events[i] = dataclasses.replace(ev, value=not ev.value)
        # kill/revive carry no value: the no-op keeps streams aligned.
    else:
        events.extend(_draw_events(rng, space)[:1])
    child = Scenario(
        name=candidate_name(seed, uid),
        rounds=space.rounds,
        events=tuple(events),
        order=space.order,
    )
    try:
        validate(child)
        _check_budgets(child, space)
    except ScenarioError:
        # A conflicting / over-budget mutation re-rolls as a fresh
        # sample under the SAME uid — still deterministic.
        return sample_campaign(space, seed, uid)
    return child


def _check_budgets(campaign: Scenario, space: SearchSpace) -> None:
    """Re-check a campaign against the space's budget knobs (mutations
    compose events, so per-event sampling discipline is not enough)."""
    if len(campaign.events) > space.events_max:
        raise ScenarioError(
            f"campaign {campaign.name!r} has {len(campaign.events)} "
            f"events, budget is {space.events_max}"
        )
    if space.faulty_max is not None:
        made_faulty = {
            g
            for ev in campaign.events
            if ev.kind == "set_faulty" and ev.value
            for g in ev.ids
        }
        if len(made_faulty) > space.faulty_max:
            raise ScenarioError(
                f"campaign {campaign.name!r} sets {len(made_faulty)} "
                f"generals faulty, faulty_max is {space.faulty_max}"
            )
    if space.kill_max is not None:
        killed = {
            g
            for ev in campaign.events
            if ev.kind == "kill"
            for g in ev.ids
        }
        if len(killed) > space.kill_max:
            raise ScenarioError(
                f"campaign {campaign.name!r} kills {len(killed)} "
                f"generals, kill_max is {space.kill_max}"
            )


def sample_population(
    space: SearchSpace, seed: int, first_uid: int = 0
) -> tuple:
    """``population`` fresh candidates with uids ``first_uid..``."""
    validate_space(space)
    return tuple(
        sample_campaign(space, seed, first_uid + i)
        for i in range(space.population)
    )


def lower_population(
    campaigns, capacity: int, rounds: int
) -> SparseScenarioBlock:
    """Lower B candidate campaigns into ONE sparse block of batch B —
    campaign ``i`` confined to instance ``i`` via the per-instance mask.

    Each candidate lowers through the ordinary public compiler at
    batch 1 (one resolution implementation — the search cannot drift
    from what a standalone replay of the same spec lowers to), then its
    resolved events are re-tagged with ``instances=(i,)`` and the merged
    event list builds the population block, re-validated by
    ``SparseScenarioBlock.__post_init__``.  The block feeds
    ``coalesced_sweep(scenario=...)`` directly.
    """
    campaigns = tuple(campaigns)
    if not campaigns:
        raise ScenarioError("lower_population needs at least one campaign")
    merged = []
    for i, campaign in enumerate(campaigns):
        if campaign.rounds != rounds:
            raise ScenarioError(
                f"campaign {campaign.name!r} covers {campaign.rounds} "
                f"round(s), population wants {rounds}"
            )
        single = compile_scenario(
            campaign, batch=1, capacity=capacity, sparse=True
        )
        for r, kind, rows, slots, value in single.events:
            if rows not in (None, (0,)):
                raise ScenarioError(
                    f"campaign {campaign.name!r} carries instance masks "
                    f"{rows!r}; population candidates must be "
                    f"single-instance specs"
                )
            merged.append((r, kind, (i,), slots, value))
    # Spec order within a candidate is preserved; candidates write
    # disjoint instance rows, so the merge order across candidates
    # cannot change any plane cell.
    return SparseScenarioBlock(
        rounds=rounds,
        batch=len(campaigns),
        capacity=capacity,
        events=tuple(merged),
    )


def campaign_fingerprint(campaign: Scenario) -> tuple:
    """Content identity for dedup: everything but the name/provenance
    (two uids that sampled the same events are ONE discovery)."""
    return (
        campaign.rounds,
        campaign.order,
        tuple(
            (ev.round, ev.kind, ev.ids, ev.value) for ev in campaign.events
        ),
    )
