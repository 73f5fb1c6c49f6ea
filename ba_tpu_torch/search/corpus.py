"""The found-reproducer corpus: export, load and validate search finds
(the port's own copy of ``ba_tpu/search/corpus.py``).

A minimized finding exports as an ORDINARY scenario JSON spec — the
same grammar the REPL ``scenario`` command replays and ``python -m
ba_tpu_torch.scenario`` validates — into ``examples/scenarios/found/``,
with a ``provenance`` header (the spec grammar's optional metadata key)
recording the complete replay recipe:

    "provenance": {"search": {
        "seed": 7, "uid": 123, "generation": 2, "objective": "ic",
        "capacity": 8, "score": 5, "counters": {...},
        "events_before": 6}}

``(seed, uid)`` pins the candidate's PRNG key
(``fold_in(key(seed), uid)``) and ``capacity`` the padded width its
coin streams depend on, so any process can re-run the exact hunt-time
evaluation (``loop.evaluate_alone``) and check the stored counters
bit for bit.

stdlib and the scenario spec layer only: ``python -m
ba_tpu_torch.search corpus`` validates a corpus directory without
torch.  :data:`FOUND_DIR` is the repository's committed corpus, read
by the tests and never written by them.
"""

from __future__ import annotations

import os

from ba_tpu_torch.scenario.spec import (
    Scenario,
    ScenarioError,
    from_dict,
    load,
    save,
    to_dict,
)

FOUND_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "scenarios", "found",
)

# The provenance keys every exported reproducer must carry — the
# replay recipe (seed/uid), the discovery coordinates
# (generation/objective) and the expected outcome (score/counters).
PROVENANCE_KEYS = (
    "seed", "uid", "generation", "objective", "capacity", "score",
    "counters",
)


def provenance(
    entry: dict, seed: int, objective: str, capacity: int
) -> dict:
    """The ``provenance`` header for one minimized-finding entry (the
    dict shape ``loop.hunt`` builds)."""
    return {
        "search": {
            "seed": seed,
            "uid": entry["uid"],
            "generation": entry["generation"],
            "objective": objective,
            "capacity": capacity,
            "score": entry["score"],
            "counters": dict(entry["counters"]),
            "events_before": entry.get(
                "events_before", len(entry["doc"].get("events", ()))
            ),
        }
    }


def reproducer_path(dirpath: str, spec: Scenario) -> str:
    return os.path.join(dirpath, f"{spec.name}.json")


def export_found(
    entries, dirpath: str, *, seed: int, objective: str, capacity: int
):
    """Write minimized-finding entries as provenance-stamped spec files.

    Entries whose parity oracle failed (``bit_exact`` False) are
    REFUSED — an exported reproducer that replays differently alone vs
    batched is exactly the artifact this corpus must never contain.
    Returns the written paths (sorted, deterministic).
    """
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for entry in entries:
        if not entry.get("bit_exact", False):
            raise ScenarioError(
                f"finding uid={entry.get('uid')} failed the "
                f"alone-vs-in-population parity oracle — refusing to "
                f"export a non-reproducing spec"
            )
        spec = from_dict(entry["doc"])
        stamped = from_dict(
            {
                **to_dict(spec),
                "provenance": provenance(entry, seed, objective, capacity),
            }
        )
        path = reproducer_path(dirpath, stamped)
        save(path, stamped)
        paths.append(path)
    return sorted(paths)


def check_reproducer(spec: Scenario) -> Scenario:
    """Validate the corpus contract on one loaded spec: a well-formed
    ``provenance.search`` header with every replay-recipe key."""
    prov = spec.provenance or {}
    search = prov.get("search")
    if not isinstance(search, dict):
        raise ScenarioError(
            f"reproducer {spec.name!r} has no provenance.search header"
        )
    missing = [k for k in PROVENANCE_KEYS if k not in search]
    if missing:
        raise ScenarioError(
            f"reproducer {spec.name!r} provenance missing {missing}"
        )
    for key in ("seed", "uid", "generation", "capacity", "score"):
        if not isinstance(search[key], int) or isinstance(
            search[key], bool
        ):
            raise ScenarioError(
                f"reproducer {spec.name!r} provenance {key}="
                f"{search[key]!r} must be an int"
            )
    if not isinstance(search["counters"], dict) or not search["counters"]:
        raise ScenarioError(
            f"reproducer {spec.name!r} provenance counters must be a "
            f"non-empty object"
        )
    return spec


def load_corpus(dirpath: str):
    """Load + contract-check every ``*.json`` reproducer in ``dirpath``
    (sorted for determinism).  Returns a list of validated specs."""
    if not os.path.isdir(dirpath):
        raise ScenarioError(f"corpus directory {dirpath!r} does not exist")
    specs = []
    for name in sorted(os.listdir(dirpath)):
        if name.endswith(".json"):
            specs.append(
                check_reproducer(load(os.path.join(dirpath, name)))
            )
    if not specs:
        raise ScenarioError(
            f"corpus directory {dirpath!r} holds no .json reproducers"
        )
    return specs
