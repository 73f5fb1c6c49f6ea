"""Alias and import resolution (``ba_tpu/analysis/resolver.py``).

Two jobs:

- **Module naming** (:func:`module_name`): map a file path to its dotted
  module name by walking up through ``__init__.py`` parents.  Rules
  scope on module names (``ba_tpu_torch.parallel.pipeline``), not raw
  paths, so a mutation check on a temporary copy of the tree scopes
  identically.
- **Alias maps** (:class:`ImportMap`): for one parsed module, map every
  locally bound name to the canonical dotted thing it refers to:
  ``import torch.cuda as tc`` binds ``tc -> torch.cuda``; ``from
  ba_tpu_torch.core.rng import split as s`` binds ``s ->
  ba_tpu_torch.core.rng.split``; relative imports resolve against the
  module's own package.  :meth:`ImportMap.resolve` then canonicalizes a
  ``Name``/``Attribute`` chain: ``tc.synchronize`` ->
  ``torch.cuda.synchronize``, whatever the local alias.

The map is flat per file (later bindings shadow earlier ones, matching
runtime rebinding; function-local imports are included).  That loses
per-scope shadowing precision, which no module in this repository relies
on — and a file that aliases one name to two different modules in
different scopes deserves a second look anyway.
"""

from __future__ import annotations

import ast
import os


def module_name(path: str) -> str:
    """Dotted module name for ``path``, by ``__init__.py`` ancestry.

    ``<anything>/ba_tpu_torch/parallel/pipeline.py`` ->
    ``ba_tpu_torch.parallel.pipeline`` wherever the tree sits (a
    mutation check analyzes a temporary copy).  A free-standing file
    (``chip_smoke.py``, ``tests/test_torch_rng.py``: ``tests/`` has no
    ``__init__.py``) is just its stem.
    """
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if parts[0] == "__init__":
        parts = parts[1:] or [os.path.basename(os.path.dirname(path))]
    return ".".join(reversed(parts))


def iter_import_aliases(tree: ast.AST, modname: str, is_package: bool):
    """``(node, local_name, binding_target, edge_target)`` per alias.

    The ONE place relative imports anchor (``project.ModuleInfo`` and
    :class:`ImportMap` both consume this).  ``level=1`` anchors at the
    containing package: the module's parent for a plain module, the
    module ITSELF for a package ``__init__`` (whose dotted name already
    IS the package — the off-by-one a naive ``parts[:-level]`` makes).

    ``binding_target`` is what the local name resolves to for alias
    canonicalization (for un-aliased ``import a.b.c`` the bound name
    ``a`` IS the root package); ``edge_target`` is the full dotted path
    the statement names, for the import graph.  ``local_name`` is
    ``None`` for a ``*`` import (no binding, but the graph edge to the
    source module is real).
    """
    parts = modname.split(".")
    pkg = parts if is_package else parts[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    yield node, a.asname, a.name, a.name
                else:
                    root = a.name.split(".")[0]
                    yield node, root, root, a.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                anchor = pkg[: len(pkg) - (node.level - 1)]
                base = ".".join(anchor + ([base] if base else []))
            if base == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    yield node, None, base, base
                else:
                    target = f"{base}.{a.name}" if base else a.name
                    yield node, a.asname or a.name, target, target


class ImportMap:
    """Local name -> canonical dotted target for one module."""

    def __init__(self, tree: ast.AST, modname: str, is_package: bool = False):
        self.modname = modname
        self.bindings: dict[str, str] = {}
        for _node, local, binding, _edge in iter_import_aliases(
            tree, modname, is_package
        ):
            if local is not None:
                self.bindings[local] = binding

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted form of a ``Name``/``Attribute`` chain.

        ``None`` when the chain bottoms out in something that is not a
        plain name (a call result, a subscript...) or in a name this
        module never imported (a local variable, a builtin).
        """
        attrs: list[str] = []
        while isinstance(node, ast.Attribute):
            attrs.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        target = self.bindings.get(node.id)
        if target is None:
            return None
        return ".".join([target] + list(reversed(attrs)))

    def resolved_refs(self, tree: ast.AST):
        """Every resolvable ``Name``/``Attribute`` chain in ``tree``.

        Yields ``(node, dotted)`` for the OUTERMOST node of each chain —
        ``rng.fold_in`` yields once as ``ba_tpu_torch.core.rng.fold_in``,
        not again for the inner ``rng``.
        """
        consumed: set[int] = set()
        for node in ast.walk(tree):
            if id(node) in consumed or not isinstance(
                node, (ast.Attribute, ast.Name)
            ):
                continue
            inner = node
            while isinstance(inner, ast.Attribute):
                consumed.add(id(inner.value))
                inner = inner.value
            dotted = self.resolve(node)
            if dotted is not None:
                yield node, dotted
