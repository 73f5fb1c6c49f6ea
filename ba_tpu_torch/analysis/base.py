"""Rule plugin base: findings, severities and the rule registry
(``ba_tpu/analysis/base.py``).

A rule is a class with a ``code`` (``BAxxx``), a short ``name``, a
``severity`` (``error`` fails the run, ``warning`` reports only), and a
``check_module(mod, project)`` generator yielding :class:`Finding` objects.
Registration is a decorator side effect at import time: the driver
imports ``ba_tpu_torch.analysis.rules`` once and every rule module
registers itself, so adding a rule is a module in ``rules/``, the
decorator on its class, and one line in ``rules/__init__``.
"""

from __future__ import annotations

import dataclasses

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit, pinned to a source location.

    ``line``/``col`` are 1-based line and 0-based column, matching both
    ``ast`` node coordinates and the ``path:line:col`` convention
    editors parse.
    """

    code: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.code} [{self.severity}] {self.message}"
        )


class Rule:
    """Base class; subclasses set the class attributes and implement
    ``check_module``."""

    code = "BA000"
    name = "abstract"
    severity = ERROR

    def check_module(self, mod, project):
        """Yield :class:`Finding` objects for one parsed module.

        ``mod`` is a :class:`ba_tpu_torch.analysis.project.ModuleInfo`;
        ``project`` the whole run's
        :class:`ba_tpu_torch.analysis.project.Project` (the import graph
        and every other module).
        """
        raise NotImplementedError
        yield  # pragma: no cover

    def finding(self, mod, node, message: str) -> Finding:
        """A :class:`Finding` at ``node``'s location in ``mod``."""
        return Finding(
            code=self.code,
            severity=self.severity,
            path=mod.display_path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


_REGISTRY: dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and index the rule by its code."""
    if cls.code in _REGISTRY:
        raise ValueError(f"duplicate rule code {cls.code}")
    _REGISTRY[cls.code] = cls()
    return cls


def all_rules() -> list[Rule]:
    """Every registered rule, code order (loads the plugins on first use)."""
    from ba_tpu_torch.analysis import rules

    rules.load_all()
    return [_REGISTRY[c] for c in sorted(_REGISTRY)]
