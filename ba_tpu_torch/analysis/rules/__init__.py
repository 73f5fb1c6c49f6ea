"""Rule plugins.  Importing a rule module registers its rules (the
``@register`` decorator); :func:`load_all` is the one place that lists
them, so adding a rule is one module plus one line here."""


def load_all() -> None:
    from ba_tpu_torch.analysis.rules import (  # noqa: F401
        concurrency,
        contracts_rules,
        dead_imports,
        donation,
        hot_path,
        obs_purity,
        rng,
    )
