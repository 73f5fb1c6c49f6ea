"""Search objectives: scores over the per-slot scenario counter blocks
(the port's own copy of ``ba_tpu/search/objective.py``).

The engine's per-candidate signal is the ``[B, C]`` final per-slot
counter block a scenario ``coalesced_sweep`` already drains inside its
depth-delayed retire fetches (``slot_counter_delta`` — row ``b`` is
bit-identical to candidate ``b``'s own B=1 run).  Scoring therefore
adds ZERO new synchronizations: this module is pure host arithmetic
over numpy rows the engine fetched anyway, and the objective table is
plain data.

Column semantics come from
``ba_tpu_torch.parallel.pipeline.SCENARIO_COUNTER_NAMES``; the engine hands
the name list back per run (``result["counter_names"]``) and every
score resolves columns BY NAME, so a counter-table reorder can never
silently re-weight an objective.  ``unanimous_rounds`` is excluded from
every objective: per slot it is the constant B=1 value (one instance
always decides unanimously), carrying no signal.

numpy/stdlib only (no torch): the search CLI's sample / corpus
subcommands load it without torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ba_tpu_torch.scenario.spec import ScenarioError


@dataclasses.dataclass(frozen=True)
class Objective:
    """One scoring rule: integer weights over counter columns, plus the
    subset whose any-nonzero verdict defines a *violation* (what the
    hunt collects, shrinks and exports)."""

    name: str
    weights: tuple  # ((counter_name, int_weight), ...)
    violation_counters: tuple  # counter names whose > 0 is a finding


# The objective table.  ``ic`` is the default
# hunt: IC1/IC2 are the paper's agreement conditions, so a nonzero
# count IS a broken-agreement campaign.  ``havoc`` weights the IC
# verdicts above the softer quorum/equivocation signals so coordinate
# descent can climb toward violations through campaigns that merely
# disturb quorum first.
OBJECTIVES = {
    "ic1": Objective(
        "ic1", (("ic1_violations", 1),), ("ic1_violations",)
    ),
    "ic2": Objective(
        "ic2", (("ic2_violations", 1),), ("ic2_violations",)
    ),
    "ic": Objective(
        "ic",
        (("ic1_violations", 1), ("ic2_violations", 1)),
        ("ic1_violations", "ic2_violations"),
    ),
    "quorum": Objective(
        "quorum", (("quorum_failures", 1),), ("quorum_failures",)
    ),
    "havoc": Objective(
        "havoc",
        (
            ("ic1_violations", 8),
            ("ic2_violations", 8),
            ("quorum_failures", 2),
            ("equivocation_observed", 1),
        ),
        ("ic1_violations", "ic2_violations"),
    ),
}


def get_objective(name) -> Objective:
    """Name -> :class:`Objective`; eager ScenarioError on unknowns (the
    hand-edited-config rule: fail before any array is built)."""
    if isinstance(name, Objective):
        return name
    try:
        return OBJECTIVES[name]
    except (KeyError, TypeError):
        raise ScenarioError(
            f"unknown search objective {name!r}; one of "
            f"{sorted(OBJECTIVES)}"
        ) from None


def _columns(counter_names, wanted, objective_name: str) -> list:
    idx = []
    for name in wanted:
        try:
            idx.append(list(counter_names).index(name))
        except ValueError:
            raise ScenarioError(
                f"objective {objective_name!r} reads counter {name!r} "
                f"which is not in the run's table {list(counter_names)}"
            ) from None
    return idx


def score_rows(rows, counter_names, objective) -> np.ndarray:
    """``[B, C]`` per-slot counter rows -> ``[B]`` int64 scores."""
    obj = get_objective(objective)
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[1] != len(tuple(counter_names)):
        raise ScenarioError(
            f"counter rows are {rows.shape}, expected "
            f"[B, {len(tuple(counter_names))}]"
        )
    names = [n for n, _ in obj.weights]
    cols = _columns(counter_names, names, obj.name)
    weights = np.array([w for _, w in obj.weights], np.int64)
    return rows[:, cols].astype(np.int64) @ weights


def violation_rows(rows, counter_names, objective) -> np.ndarray:
    """``[B, C]`` rows -> ``[B]`` bool: which slots broke the objective's
    violation counters (any nonzero)."""
    obj = get_objective(objective)
    rows = np.asarray(rows)
    cols = _columns(counter_names, obj.violation_counters, obj.name)
    return (rows[:, cols] > 0).any(axis=1)


def counters_dict(row, counter_names) -> dict:
    """One ``[C]`` per-slot row as ``{name: int}`` — the provenance /
    record form."""
    return {
        name: int(v) for name, v in zip(tuple(counter_names), row)
    }
