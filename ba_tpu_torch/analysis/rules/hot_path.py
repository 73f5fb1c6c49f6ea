"""BA101 host-sync-in-hot-path and BA102 host-key-split-in-pipeline
(``ba_tpu/analysis/rules/hot_path.py``, read for torch and CUDA).

The pipelined engine's gain is that the host never waits on the card
inside the dispatch loop: the only wait is the depth-delayed retire
(``parallel/pipeline._Inflight.fetch``), and round keys derive on the
device from the ``KeySchedule`` counter.

- **BA101** bans host syncs in the hot trees (:data:`HOT_TREES`, the
  port's names of the reference's): an alias-resolved
  ``torch.cuda.synchronize``, and ``.synchronize()`` on anything (an
  event, a stream).  They take the place of ``block_until_ready``.  In
  the dispatch-loop modules (:data:`HOT_CONVERSION_MODULES`) it also
  bans the drains: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  a ``.to("cpu")`` / ``.to(device="cpu")`` / ``.to(torch.device("cpu"))``
  without ``non_blocking=True``, and ``float()`` / ``int()`` / ``bool()``
  of a torch-derived value (an argument that names ``torch``,
  alias-resolved).  The one sanctioned sync, ``_Inflight.fetch``,
  carries a named inline suppression.
  *Departure from the reference:* numpy conversions (``np.asarray``,
  ``np.array``, ``np.ascontiguousarray``) are not flagged.  A CUDA
  tensor has no ``__array__`` path to the host (numpy raises on it), so
  such a call cannot drain the queue silently; in the port it only ever
  stages host data.  A wait hidden behind it would need a ``.cpu()`` or
  ``.numpy()`` first, which the rule flags.
- **BA102** keeps the host out of key derivation in
  ``parallel/pipeline.py``: any alias-resolved
  ``ba_tpu_torch.core.rng.split`` (a split there means the host is back
  in the per-round loop), and ``ba_tpu_torch.core.rng.fold_in`` inside
  a host ``for`` / ``while`` body (``round_keys`` folds the counter in
  once a dispatch, outside any host loop).
"""

from __future__ import annotations

import ast

from ba_tpu_torch.analysis.base import Rule, register

# The dispatch path: the parallel loops, K1's wrappers (the dispatch
# when engine="cuda"), the search loop that drives the coalesced engine,
# and the host crypto pool the sign-ahead lane calls from the engine's
# overlap slot.
HOT_TREES = (
    "ba_tpu_torch.parallel.", "ba_tpu_torch.ops.scenario_step",
    "ba_tpu_torch.search.loop", "ba_tpu_torch.crypto.pool",
)
# The modules whose statements run once a round or a dispatch: mesh and
# multihost build host topology and stay out.
HOT_CONVERSION_MODULES = {
    "ba_tpu_torch.parallel.pipeline",
    "ba_tpu_torch.parallel.sweep",
    "ba_tpu_torch.parallel.shard",
    "ba_tpu_torch.ops.scenario_step",
    "ba_tpu_torch.search.loop",
}
PIPELINE_MODULE = "ba_tpu_torch.parallel.pipeline"
RNG = "ba_tpu_torch.core.rng"

_SYNC_MSG = (
    "host sync in a dispatch-path module: the host waits for the card "
    "and the queue drains; the engine's only wait is the depth-delayed "
    "retire (_Inflight.fetch)"
)
_DRAIN_METHODS = {"item", "tolist", "cpu", "numpy"}


def _is_cpu_device(node) -> bool:
    """``"cpu"``, or ``torch.device("cpu")`` under any alias spelling."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "device"
        and len(node.args) == 1
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


def _blocking_to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` without
    ``non_blocking=True``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    target = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "device":
            target = kw.value
        elif kw.arg == "non_blocking" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is False
        ):
            return False
    return target is not None and _is_cpu_device(target)


def _loop_node_ids(tree: ast.AST) -> set:
    """ids of every node lexically inside a host ``for``/``while`` body."""
    inside: set = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            for sub in node.body + node.orelse:
                for inner in ast.walk(sub):
                    inside.add(id(inner))
    return inside


@register
class HostSyncInHotPath(Rule):
    code = "BA101"
    name = "host-sync-in-hot-path"
    severity = "error"

    def check_module(self, mod, project):
        if not mod.modname.startswith(HOT_TREES):
            return
        seen: set = set()

        def hit(node, msg):
            key = (node.lineno, node.col_offset)
            if key not in seen:
                seen.add(key)
                yield self.finding(mod, node, msg)

        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "synchronize"
            ):
                yield from hit(node, _SYNC_MSG)
        for node, dotted in mod.imports.resolved_refs(mod.tree):
            if dotted == "torch.cuda.synchronize":
                yield from hit(node, _SYNC_MSG)

        if mod.modname not in HOT_CONVERSION_MODULES:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _DRAIN_METHODS
            ):
                yield from hit(
                    node,
                    f".{node.func.attr}() in a dispatch-loop module copies "
                    "to the host and waits for the card each call",
                )
            elif _blocking_to_cpu(node):
                yield from hit(
                    node,
                    "a blocking .to('cpu') in a dispatch-loop module waits "
                    "for the card (stage through pinned memory with "
                    "non_blocking=True and an event instead)",
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and node.func.id not in mod.imports.bindings
                and any(
                    d == "torch" or d.startswith("torch.")
                    for a in node.args
                    for _, d in mod.imports.resolved_refs(a)
                )
            ):
                yield from hit(
                    node,
                    f"{node.func.id}() of a torch value in a dispatch-loop "
                    "module waits for the card's result",
                )


@register
class HostKeySplitInPipeline(Rule):
    code = "BA102"
    name = "host-key-split-in-pipeline"
    severity = "error"

    def check_module(self, mod, project):
        if mod.modname != PIPELINE_MODULE:
            return
        in_loop = _loop_node_ids(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = mod.imports.resolve(node.func)
            if dotted == f"{RNG}.split":
                yield self.finding(
                    mod,
                    node,
                    "host key split in pipeline.py: round keys derive on "
                    "the device from the KeySchedule counter "
                    "(fold_in(fold_in(base, counter + r), i), round_keys); "
                    "a host split puts the host back in the per-round loop",
                )
            elif dotted == f"{RNG}.fold_in" and id(node) in in_loop:
                yield self.finding(
                    mod,
                    node,
                    "host-loop fold_in in pipeline.py: per-round key "
                    "derivation belongs to round_keys, once a dispatch, "
                    "not to a host loop",
                )
