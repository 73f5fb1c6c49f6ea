"""The whole run: parsed modules, the import graph and the consume
registry's record type (``ba_tpu/analysis/project.py``).

The analyzer runs in two phases.  Phase one parses every file into a
:class:`ModuleInfo` (tree, alias map, suppression index, import
records).  Phase two builds the facts that no single tree shows:

- the **direct-import graph** over the analyzed set, resolving ``from X
  import y`` to the longest analyzed-module prefix (module or symbol,
  both land on the defining module), which BA301's closures walk;
- the **consume lookup** (:meth:`Project.donation_for`): a call's
  function, alias-resolved, against the table BA201 builds from the
  ``# ba-lint: donates(...)`` annotations and its own known names.

Departure from the reference: there is no ``jax.jit(donate_argnums=)``
to discover, so the registry is fed by annotations and BA201's table
alone.  A megastep of the port updates its carry in place; that
contract is written on its ``def`` line, never in a decorator.

"Direct-import" follows the modules the code names (what it could call
into), not the load side effects of a package ``__init__``: ``from
ba_tpu_torch.parallel.mesh import Mesh`` runs
``ba_tpu_torch/parallel/__init__.py``, but gives the importer no handle
on ``ba_tpu_torch.parallel.pipeline``.  The obs-purity contract is about
reachable code, and this keeps its verdict stable when re-export lists
change.
"""

from __future__ import annotations

import ast
import dataclasses

from ba_tpu_torch.analysis.resolver import (
    ImportMap,
    iter_import_aliases,
    module_name,
)
from ba_tpu_torch.analysis.suppress import SuppressionIndex


@dataclasses.dataclass
class ModuleInfo:
    path: str
    display_path: str
    modname: str
    source: str
    tree: ast.Module
    imports: ImportMap
    suppressions: SuppressionIndex
    # (ast node, raw dotted target) per imported alias: the node is the
    # finding anchor for import-graph rules.
    import_records: list

    @classmethod
    def parse(cls, path: str, display_path: str, source: str) -> "ModuleInfo":
        tree = ast.parse(source, filename=display_path)
        modname = module_name(path)
        is_package = path.endswith("__init__.py")
        records = [
            (node, edge)
            for node, _local, _binding, edge in iter_import_aliases(
                tree, modname, is_package
            )
        ]
        return cls(
            path=path,
            display_path=display_path,
            modname=modname,
            source=source,
            tree=tree,
            imports=ImportMap(tree, modname, is_package),
            suppressions=SuppressionIndex(source),
            import_records=records,
        )


@dataclasses.dataclass(frozen=True)
class DonationSpec:
    """The consumed positions (and parameter names, for keyword call
    sites) of one callable."""

    positions: frozenset
    param_names: tuple = ()

    def donated_params(self) -> set:
        return {
            self.param_names[i]
            for i in self.positions
            if i < len(self.param_names)
        }


class Project:
    """Everything rules may ask about the analyzed set as a whole."""

    def __init__(self, modules: list):
        self.modules = {m.modname: m for m in modules}
        self._reach_memo: dict = {}

    # -- consume registry -------------------------------------------------

    def donation_for(self, mod: ModuleInfo, func: ast.AST, table: dict):
        """The :class:`DonationSpec` a call's function resolves to in
        ``table``, if any: a name defined in this module first, then the
        alias-resolved qualified name (call sites in other modules)."""
        candidates = []
        if isinstance(func, ast.Name):
            candidates.append(f"{mod.modname}.{func.id}")
        dotted = mod.imports.resolve(func)
        if dotted:
            candidates.append(dotted)
        for cand in candidates:
            spec = table.get(cand)
            if spec is not None:
                return spec
        return None

    # -- import graph -----------------------------------------------------

    def resolve_target_module(self, target: str) -> str | None:
        """Longest analyzed-module prefix of a raw import target."""
        parts = target.split(".")
        for k in range(len(parts), 0, -1):
            cand = ".".join(parts[:k])
            if cand in self.modules:
                return cand
        return None

    def reaches(
        self, modname: str, prefix, through=None, memo=None
    ) -> bool:
        """True when ``modname``'s direct-import closure names a module
        under ``prefix`` (e.g. ``ba_tpu_torch.obs``), or, when ``prefix``
        is a predicate, an import target it accepts.

        ``through`` optionally filters which analyzed modules the walk
        may enter (BA301 passes its device-tree predicate so host-layer
        modules act as boundaries); the start module is always examined.
        A caller with ``through`` supplies its own ``memo`` dict: the
        default memo holds the unfiltered closure only.

        An iterative walk over the analyzed set: an import cycle is a
        revisit against ``seen`` (a recursive memo would cache wrong
        negatives inside a cycle).
        """
        if memo is None:
            if through is not None:
                raise ValueError("custom `through` needs its own memo")
            memo = self._reach_memo
        key = (modname, prefix)
        if key in memo:
            return memo[key]
        if callable(prefix):
            is_hit = prefix
        else:
            def is_hit(target):
                return target == prefix or target.startswith(prefix + ".")
        seen = {modname}
        frontier = [modname]
        hit = False
        while frontier and not hit:
            mod = self.modules.get(frontier.pop())
            if mod is None:
                continue
            for _, target in mod.import_records:
                if is_hit(target):
                    hit = True
                    break
                nxt = self.resolve_target_module(target)
                if (
                    nxt
                    and nxt not in seen
                    and (through is None or through(nxt))
                ):
                    seen.add(nxt)
                    frontier.append(nxt)
        memo[key] = hit
        return hit
