"""Minimal-reproducer mining: delta-debugging shrink + the parity oracle
(the port's copy of ``ba_tpu/search/minimize.py``).

A hunt's raw finding is whatever event soup the sampler landed on; the
committable artifact is the MINIMAL event set that still breaks the
objective.  :func:`shrink` is classic ddmin over the campaign's event
list — remove chunks at doubling granularity, then a 1-minimal pass —
where each trial replays the candidate ALONE at B=1 under its own
``(seed, uid)`` key (``loop.evaluate_alone``) and keeps the removal iff
the violation survives.  Every surviving event is therefore
load-bearing: removing any single one loses the violation.

:func:`verify_minimized` is the correctness oracle the export gate
runs: the shrunk spec replayed alone must be BIT-EXACT
(decisions/leaders/counters) with the same spec evaluated inside a
co-population (slot 0 of a padded batch) — the serving parity pin
(``coalesced_sweep``: slot b ≡ its own B=1 run) reused as the search's
ground truth.  A reproducer that passes replays identically wherever
it runs: standalone, in a population, or from its exported JSON via
``scenario_sweep``.

Importing this module loads no torch: the evaluation engine loads
through ``ba_tpu_torch.search.loop``'s function-body imports.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ba_tpu_torch.scenario.spec import Scenario, ScenarioError, validate
from ba_tpu_torch.search import objective as _objective


def _violates(result: dict, objective) -> bool:
    rows = np.asarray(result["counters"])[None, :]
    return bool(
        _objective.violation_rows(
            rows, result["counter_names"], objective
        )[0]
    )


def _with_events(campaign: Scenario, events) -> Scenario:
    return validate(
        dataclasses.replace(campaign, events=tuple(events))
    )


def shrink(
    campaign: Scenario,
    *,
    seed: int,
    uid: int,
    capacity: int,
    objective="ic",
    depth: int = 2,
    rounds_per_dispatch: int = 8,
    engine: str | None = None,
    device=None,
    evaluate=None,
):
    """ddmin the campaign's event list to a 1-minimal violating set.

    ``evaluate`` (injectable for tests) maps a candidate
    :class:`Scenario` to ``loop.evaluate_alone``'s result dict; the
    default replays at B=1 under the candidate's own ``(seed, uid)``
    key on ``device``.  Raises :class:`ScenarioError` if ``campaign``
    itself does not violate — shrinking a non-finding would "converge" to the empty
    campaign and export garbage.

    Returns ``(shrunk_campaign, info)`` with ``info`` =
    ``{"events_before", "events_after", "evals"}``.
    """
    obj = _objective.get_objective(objective)
    if evaluate is None:
        from ba_tpu_torch.search.loop import evaluate_alone

        def evaluate(c):
            return evaluate_alone(
                c, seed=seed, uid=uid, capacity=capacity, depth=depth,
                rounds_per_dispatch=rounds_per_dispatch, engine=engine,
                device=device,
            )

    evals = 0

    def still_violates(events) -> bool:
        nonlocal evals
        evals += 1
        return _violates(evaluate(_with_events(campaign, events)), obj)

    events = list(campaign.events)
    if not still_violates(events):
        raise ScenarioError(
            f"campaign {campaign.name!r} does not violate objective "
            f"{obj.name!r} — nothing to shrink"
        )
    # ddmin: try dropping complement chunks at doubling granularity.
    n = 2
    while len(events) >= 2:
        chunk = max(1, len(events) // n)
        reduced = False
        i = 0
        while i < len(events):
            trial = events[:i] + events[i + chunk:]
            if trial and still_violates(trial):
                events = trial
                n = max(n - 1, 2)
                reduced = True
            else:
                i += chunk
        if not reduced:
            if chunk == 1:
                break
            n = min(n * 2, len(events))
    # 1-minimal pass: every surviving event is individually load-bearing.
    i = 0
    while i < len(events) and len(events) > 1:
        trial = events[:i] + events[i + 1:]
        if still_violates(trial):
            events = trial
        else:
            i += 1
    shrunk = _with_events(campaign, events)
    return shrunk, {
        "events_before": len(campaign.events),
        "events_after": len(events),
        "evals": evals,
    }


def verify_minimized(
    campaign: Scenario,
    *,
    seed: int,
    uid: int,
    capacity: int,
    objective="ic",
    pad: int = 3,
    depth: int = 2,
    rounds_per_dispatch: int = 8,
    engine: str | None = None,
    device=None,
):
    """The export gate: replay ``campaign`` alone AND at slot 0 of a
    ``1 + pad`` co-population (pad slots run the empty campaign under
    :data:`~ba_tpu.search.loop.PAD_UID_BASE` keys), and compare the
    candidate's decisions/leaders/counters bit-exactly.

    Returns ``{"bit_exact": bool, "violates": bool, "score": int,
    "counters": {name: int}}`` — ``bit_exact`` is the parity-oracle
    verdict, ``violates``/``score`` read the ALONE run (the one the
    exported spec's provenance describes).
    """
    from ba_tpu_torch.search import generate as _generate
    from ba_tpu_torch.search.loop import (
        PAD_UID_BASE,
        candidate_keys,
        evaluate_alone,
        evaluate_population,
        population_state,
    )

    obj = _objective.get_objective(objective)
    alone = evaluate_alone(
        campaign, seed=seed, uid=uid, capacity=capacity, depth=depth,
        rounds_per_dispatch=rounds_per_dispatch, engine=engine,
        device=device,
    )
    pads = [
        Scenario(
            name=f"pad-{j}",
            rounds=campaign.rounds,
            events=(),
            order=campaign.order,
        )
        for j in range(pad)
    ]
    block = _generate.lower_population(
        [campaign] + pads, capacity, campaign.rounds
    )
    keys = candidate_keys(
        seed, [uid] + [PAD_UID_BASE + j for j in range(pad)]
    )
    state = population_state(1 + pad, capacity, campaign.order, device)
    pop = evaluate_population(
        keys, state, block,
        rounds=campaign.rounds, depth=depth,
        rounds_per_dispatch=rounds_per_dispatch, engine=engine,
        device=device,
    )
    bit_exact = (
        np.array_equal(alone["decisions"], pop["decisions"][:, 0])
        and np.array_equal(alone["leaders"], pop["leaders"][:, 0])
        and np.array_equal(alone["counters"], pop["counters"][0])
        and list(alone["counter_names"]) == list(pop["counter_names"])
    )
    rows = np.asarray(alone["counters"])[None, :]
    return {
        "bit_exact": bool(bit_exact),
        "violates": _violates(alone, obj),
        "score": int(
            _objective.score_rows(rows, alone["counter_names"], obj)[0]
        ),
        "counters": _objective.counters_dict(
            alone["counters"], alone["counter_names"]
        ),
    }
