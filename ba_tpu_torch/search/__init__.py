"""The adversary search engine (counterpart of ``ba_tpu.search``).

Four layers, each the reference's:

- **generator** (``search/generate.py``): a deterministic seed-keyed
  campaign sampler and mutator over the scenario spec grammar, with
  constraints as plain data (:class:`~ba_tpu_torch.search.generate.SearchSpace`,
  validated eagerly) and a population lowering that packs B candidate
  campaigns into one batched block, candidate i confined to instance i.
- **objective** (``search/objective.py``): scores over the per-slot
  scenario counter rows that ``coalesced_sweep`` already fetches in its
  depth-delayed retires, so scoring adds no wait on the card.
- **search loop** (``search/loop.py``): random sweep, elite selection,
  mutation; B campaigns a population through K1's slot mode with
  scenario planes on the card; per-candidate keys ``fold_in(key(seed),
  uid)``; versioned search-state checkpoints (``utils/snapshot``) that
  resume bit-exactly, in either package; ``mesh=`` per-entry
  populations; the ``search_*`` records under one run id.
- **minimizer and corpus** (``search/minimize.py``, ``search/corpus.py``):
  ddmin to a 1-minimal violating event set, checked by the alone vs
  in-population replay oracle, exported as provenance-stamped scenario
  JSON specs.

Importing this package loads numpy and the scenario spec layer, never
torch: :func:`hunt` loads on attribute access.
"""

from ba_tpu_torch.search.corpus import (
    FOUND_DIR,
    check_reproducer,
    export_found,
    load_corpus,
)
from ba_tpu_torch.search.generate import (
    SearchSpace,
    campaign_fingerprint,
    candidate_name,
    lower_population,
    mutate_campaign,
    sample_campaign,
    sample_population,
    space_from_dict,
    space_to_dict,
    validate_space,
)
from ba_tpu_torch.search.objective import (
    OBJECTIVES,
    Objective,
    get_objective,
    score_rows,
    violation_rows,
)

__all__ = [
    "FOUND_DIR",
    "OBJECTIVES",
    "Objective",
    "SearchSpace",
    "campaign_fingerprint",
    "candidate_name",
    "check_reproducer",
    "export_found",
    "get_objective",
    "hunt",
    "load_corpus",
    "lower_population",
    "mutate_campaign",
    "sample_campaign",
    "sample_population",
    "score_rows",
    "space_from_dict",
    "space_to_dict",
    "validate_space",
    "violation_rows",
]


def __getattr__(name):
    # Lazy: `hunt` pulls the whole parallel engine (and jax) — it must
    # not ride the jax-free CLI / CI validation import path.
    if name == "hunt":
        from ba_tpu_torch.search.loop import hunt

        return hunt
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
