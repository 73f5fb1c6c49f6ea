"""BA301 obs-purity (``ba_tpu/analysis/rules/obs_purity.py``, read for
the port's layering).

Observability is host-only: a span or ``metrics.emit`` inside the device
math would time the host's enqueue instead of the card's work, or make a
kernel wrapper wait for a sink.  The device trees are
``ba_tpu_torch.core`` and ``ba_tpu_torch.ops`` (:data:`SCOPES`); the
instrumentation lives in ``runtime/``, the ``parallel/`` loop drivers,
the crypto host paths and ``chip_smoke.py``.  The rule works on the real
import graph, alias-resolved, in both directions:

- **Forward.** A ``core`` / ``ops`` module importing
  ``ba_tpu_torch.obs`` under any spelling is flagged at the import; so
  is an import of another device-tree module whose own device-tree
  closure reaches obs (the finding lands on the edge that lets it in),
  and any alias-resolved reference to ``ba_tpu_torch.obs...`` or to
  ``ba_tpu_torch.utils.metrics...emit``.  The closure follows edges
  only through device-tree modules: a host-layer module may instrument
  its own host path.
- **Reverse, strict.** ``ba_tpu_torch.obs`` modules never import the
  device trees, directly or through any intermediary, even inside a
  function: ``import ba_tpu_torch.obs`` stays free of torch
  (``tests/test_torch_isolation.py``) and the flight recorder and health
  sampler run from watchdog threads and exit hooks.
- **Reverse, module level** (:data:`HOST_TIER_MODULES`, the
  reference's list with the port's names): the serving front end, the
  warmup pass, the search package, the fleet tier and the checkpoint
  reader import without torch and reach the engine only through
  function-local imports, the sanctioned lazy seam.  One host-tier
  module importing another is the tier's composition, checked at the
  target's own entry.

Two decisions of the torch meaning, each declared in a table with its
reason rather than by one suppression a line:

- :data:`HOST_IN_DEVICE_TREE`: ``ops/_build.py`` sits in ``ops/`` but is
  the build-and-load helper (``nvcc``, ``ctypes``, the ``ptxas`` log),
  standard library only.  It is host tier: obs may call it (the
  artifact records read its ``ptxas`` resources), and it may import no
  device module.  A test loads it alone and pins that it loads no torch.
- :data:`OBS_DEVICE_SEAMS`: ``obs/graphcache.py`` captures K1's slot
  mode as a CUDA graph itself, so it reaches ``ops.scenario_step``,
  ``core.state`` and ``parallel.pipeline`` from its builders.  It is
  held to the module-level rule instead of obs's strict one.
  *Departure from the reference:* the reference's executable cache
  (``obs/aotcache.py``) received its executables from
  ``parallel/pipeline.py`` and needed no exception.
"""

from __future__ import annotations

import ast

from ba_tpu_torch.analysis.base import Rule, register

SCOPES = ("ba_tpu_torch.core", "ba_tpu_torch.ops")
OBS = "ba_tpu_torch.obs"
SINK = "ba_tpu_torch.utils.metrics"
HOST_IN_DEVICE_TREE = {
    "ba_tpu_torch.ops._build": (
        "the kernels' build-and-load helper: nvcc, ctypes and the ptxas "
        "log, standard library only"
    ),
}
OBS_DEVICE_SEAMS = {
    "ba_tpu_torch.obs.graphcache": (
        "captures K1's slot mode as a CUDA graph itself, so its builders "
        "import the engine lazily"
    ),
}
HOST_TIER_MODULES = (
    "ba_tpu_torch.runtime.serve",
    "ba_tpu_torch.runtime.warmup",
    "ba_tpu_torch.search",
    "ba_tpu_torch.search.__main__",
    "ba_tpu_torch.search.generate",
    "ba_tpu_torch.search.objective",
    "ba_tpu_torch.search.loop",
    "ba_tpu_torch.search.minimize",
    "ba_tpu_torch.search.corpus",
    "ba_tpu_torch.fleet",
    "ba_tpu_torch.fleet.router",
    "ba_tpu_torch.fleet.replica",
    "ba_tpu_torch.fleet.migrate",
    "ba_tpu_torch.utils.snapshot",
)


def _under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def _in_scope(name: str) -> bool:
    """A device-tree module, or an import target inside one."""
    return any(_under(name, s) for s in SCOPES) and not any(
        _under(name, h) for h in HOST_IN_DEVICE_TREE
    )


def _is_obs(target: str) -> bool:
    return _under(target, OBS)


@register
class ObsPurity(Rule):
    code = "BA301"
    name = "obs-purity"
    severity = "error"

    def check_module(self, mod, project):
        if mod.modname in OBS_DEVICE_SEAMS or mod.modname in HOST_TIER_MODULES:
            yield from self._check_host_tier(mod, project, module_level_only=True)
            return
        if _is_obs(mod.modname) or mod.modname in HOST_IN_DEVICE_TREE:
            yield from self._check_host_tier(mod, project)
            return
        if not _in_scope(mod.modname):
            return
        # Memoized per Project (rule instances are registry singletons
        # shared across runs; a memo across runs would go stale).
        memo = project.__dict__.setdefault("_ba301_memo", {})
        seen_lines: set = set()

        def once(node, message):
            if node.lineno not in seen_lines:
                seen_lines.add(node.lineno)
                yield self.finding(mod, node, message)

        for node, target in mod.import_records:
            if _is_obs(target):
                yield from once(
                    node,
                    f"device-tree module imports {OBS}: observability is "
                    "host-only (a span or emit beside a kernel launch "
                    "times the enqueue, not the card); instrument the "
                    "caller in runtime/ or parallel/ instead",
                )
                continue
            nxt = project.resolve_target_module(target)
            if (
                nxt
                and nxt != mod.modname
                and _in_scope(nxt)
                and project.reaches(nxt, OBS, through=_in_scope, memo=memo)
            ):
                yield from once(
                    node,
                    f"device-tree module imports '{target}', whose "
                    f"device-tree import closure reaches {OBS}: "
                    "observability is host-only",
                )
        for node, dotted in mod.imports.resolved_refs(mod.tree):
            if _is_obs(dotted):
                yield from once(
                    node,
                    f"reference to {dotted} inside a device-tree module: "
                    "observability is host-only",
                )
            elif dotted.startswith(SINK + ".") and dotted.endswith(".emit"):
                yield from once(
                    node,
                    "metrics sink emit inside a device-tree module: the "
                    "JSONL sink is host-only; emit from the loop driver",
                )

    def _check_host_tier(self, mod, project, module_level_only=False):
        """The reverse direction: no import of the device trees, directly
        or through any intermediary (the closure here is unfiltered: a
        host-tier module that pulls ``ba_tpu_torch.parallel`` in pays the
        torch import, whoever sits in the middle).  With
        ``module_level_only`` an import inside a function body is the
        sanctioned lazy seam and is skipped."""
        seen_lines: set = set()

        def once(node, message):
            if node.lineno not in seen_lines:
                seen_lines.add(node.lineno)
                yield self.finding(mod, node, message)

        lazy_spans = ()
        if module_level_only:
            lazy_spans = tuple(
                (f.lineno, f.end_lineno or f.lineno)
                for f in ast.walk(mod.tree)
                if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
            )

        def is_lazy(node) -> bool:
            return any(lo <= node.lineno <= hi for lo, hi in lazy_spans)

        tier = (
            f"{mod.modname} is host-tier at module level (function-body "
            f"imports are the sanctioned lazy seam)"
            if module_level_only
            else f"{mod.modname} stays importable without torch and reaches "
            f"no device tree, not even in a function; observe the drivers "
            f"from runtime/ or parallel/ instead"
        )
        for node, target in mod.import_records:
            if module_level_only and is_lazy(node):
                continue
            if _in_scope(target):
                yield from once(
                    node,
                    f"host-tier module imports '{target}', a device-tree "
                    f"module (ba_tpu_torch.core/ops): {tier}",
                )
                continue
            nxt = project.resolve_target_module(target)
            if (
                nxt
                and nxt != mod.modname
                and (nxt in HOST_TIER_MODULES or nxt in OBS_DEVICE_SEAMS)
            ):
                # Its own module-level closure is checked at its own
                # entry; its sanctioned function-local seams must not
                # poison importers through the unfiltered walk below.
                continue
            if (
                nxt
                and nxt != mod.modname
                and project.reaches(nxt, _in_scope)
            ):
                yield from once(
                    node,
                    f"host-tier module imports '{target}', whose import "
                    f"closure reaches the device trees "
                    f"(ba_tpu_torch.core/ops): {tier}",
                )
