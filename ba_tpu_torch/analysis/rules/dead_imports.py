"""BA401 dead-import (warning severity; ``ba_tpu/analysis/rules/
dead_imports.py``, carried over as it is).

A dead import is noise at best; at worst it is a latent layering leak:
an unused ``from ba_tpu_torch.parallel import ...`` in a core module
would hold an edge toward ``obs`` open for BA301 the day someone uses
it.

A name counts as used when it appears as a ``Name`` load anywhere in the
module (attribute chains count through their base name), or when a
string ``__all__`` lists it (a re-export: ``crypto/signed.py``
re-exports the host tier of ``crypto/tables.py`` this way).
``__init__.py`` files are skipped wholesale: their imports are their
API.  ``from __future__`` and explicit-intent ``as _`` bindings are
exempt.

Warning severity: findings print and count, but never fail the run.
"""

from __future__ import annotations

import ast

from ba_tpu_torch.analysis.base import WARNING, Rule, register


def _all_names(tree: ast.Module) -> set:
    """String entries of a top-level ``__all__`` assignment."""
    names: set = set()
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        if not any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in targets
        ):
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Constant) and isinstance(
                sub.value, str
            ):
                names.add(sub.value)
    return names


@register
class DeadImport(Rule):
    code = "BA401"
    name = "dead-import"
    severity = WARNING

    def check_module(self, mod, project):
        if mod.path.endswith("__init__.py"):
            return
        bound = []  # (node, local name, imported thing)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    bound.append((node, local, a.name))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    bound.append((node, a.asname or a.name, a.name))
        if not bound:
            return
        used = {
            n.id
            for n in ast.walk(mod.tree)
            if isinstance(n, ast.Name)
        }
        used |= _all_names(mod.tree)
        for node, local, imported in bound:
            if local in used or local == "_":
                continue
            yield self.finding(
                mod,
                node,
                f"'{imported}' imported as '{local}' is never used "
                "(add to __all__ if it is a deliberate re-export)",
            )
