"""BA201 use-after-donate: a carry read after a megastep updated it in
place (``ba_tpu/analysis/rules/donation.py``, read for torch).

The torch meaning: the port's megasteps (K1's wrappers in
``ops/scenario_step.py``, the torch megasteps and sweeps in
``parallel/pipeline.py``, the mesh megasteps in ``parallel/shard.py``)
update their carry in place: the state planes, the strategy plane and
the schedule's counter are written by the dispatch, and the sweeps
consume the state they are given.  A read of the old name after the
call sees a changed carry (or, while the dispatch is still queued on the
card, one about to change), where the reference's read would raise on a
deleted buffer.  This rule is the static twin of
``pipeline.CarryConsumed``, which stops a seam from running a dispatch
twice on a half-written carry: after a statement that passes local name
``x`` at a consumed position, any read of ``x`` before a rebinding is a
finding.  Rebinding to the call's result (``state, sched, hist =
megastep(state, sched, ...)``) is the sanctioned form, and
``pipeline.fresh_copy(x)`` before the call keeps a copy that survives.

The consuming callables come from two places, merged in this order:

1. :data:`KNOWN_DONATING`, the port's names of the reference's table;
2. the ``# ba-lint: donates(name, ...)`` annotation on a function's own
   ``def`` line, which wins over the table::

       def cuda_pipeline_megastep(  # ba-lint: donates(state, sched)
           state, sched, *, rounds, ...

   The comment must sit on the ``def`` line itself (a docstring that
   documents the syntax, like this one, never registers), and the names
   must be positional parameters of that function, else the annotation
   is itself a finding.  Call sites in other modules resolve through
   their import aliases.

Departure from the reference: no ``jax.jit(donate_argnums=)``
decorators are discovered (the port has none); the annotations carry
the contract the decorators carried.

The walk is the shared must-flow walk (``analysis/flow.py``):
evaluation-ordered events, intersection joins at branches (a consume on
one path never poisons the other), and loop bodies walked twice so a
consume at the bottom of a loop catches the read at the top of the next
iteration.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize

from ba_tpu_torch.analysis.base import Rule, register
from ba_tpu_torch.analysis.flow import (
    FlowHandler,
    FlowState,
    function_scopes,
    walk_body,
)
from ba_tpu_torch.analysis.project import DonationSpec

_P = "ba_tpu_torch.parallel.pipeline"
_S = "ba_tpu_torch.parallel.shard"
_K = "ba_tpu_torch.ops.scenario_step"
# The consuming entry points by qualified name: a fallback for call
# sites whose callee lost its annotation in a refactor (the annotations
# on the def lines shadow these rows).
KNOWN_DONATING = {
    f"{_P}.pipeline_sweep": DonationSpec(frozenset([1]), ("key", "state")),
    f"{_P}.pipeline_megastep": DonationSpec(
        frozenset([0, 1]), ("state", "sched")
    ),
    f"{_P}.scenario_megastep": DonationSpec(
        frozenset([0, 1, 2]), ("state", "sched", "strategy")
    ),
    f"{_P}.coalesced_megastep": DonationSpec(
        frozenset([0, 1, 2]), ("state", "sched", "strategy")
    ),
    f"{_P}.signed_megastep": DonationSpec(
        frozenset([0, 1]), ("state", "sched")
    ),
    f"{_P}.coalesced_signed_megastep": DonationSpec(
        frozenset([0, 1]), ("state", "sched")
    ),
    f"{_S}.sharded_pipeline_megastep": DonationSpec(
        frozenset([0, 1]), ("state", "sched")
    ),
    f"{_S}.sharded_scenario_megastep": DonationSpec(
        frozenset([0, 1, 2]), ("state", "sched", "strategy")
    ),
    f"{_K}.cuda_pipeline_megastep": DonationSpec(
        frozenset([0, 1]), ("state", "sched")
    ),
    f"{_K}.cuda_scenario_megastep": DonationSpec(
        frozenset([0, 1, 2]), ("state", "sched", "strategy")
    ),
    f"{_K}.cuda_coalesced_megastep": DonationSpec(
        frozenset([0, 1, 2]), ("state", "sched", "strategy")
    ),
    "ba_tpu_torch.search.loop.evaluate_population": DonationSpec(
        frozenset([1]), ("slot_keys", "state", "block")
    ),
}

_DONATES_RE = re.compile(r"#\s*ba-lint:\s*donates\(([^)]*)\)")


def annotated_donations(mod) -> tuple:
    """``({qualified name: DonationSpec}, [(lineno, message)])`` for
    every function in ``mod`` whose ``def`` line carries a ``# ba-lint:
    donates(a, b)`` comment.

    Directives parse from REAL comment tokens (``tokenize``, exactly
    like the suppression index) — a docstring that merely documents the
    syntax never registers — and anchor by line number: the comment
    must sit on the exact line a ``FunctionDef`` starts on (multi-line
    signatures annotate the ``def foo(`` line).  A name that is not a
    positional parameter of its function comes back as an error entry
    (BA201 reports it at the annotation line): a typo'd annotation
    silently protecting nothing is worse than none.
    """
    hits = {}
    try:
        tokens = tokenize.generate_tokens(
            io.StringIO(mod.source).readline
        )
        comments = [
            (tok.start[0], tok.string)
            for tok in tokens
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {}, []  # unparseable files already surface as BA900
    for lineno, text in comments:
        m = _DONATES_RE.search(text)
        if m:
            names = tuple(
                s.strip() for s in m.group(1).split(",") if s.strip()
            )
            if names:
                hits[lineno] = names
    if not hits:
        return {}, []
    specs, errors = {}, []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        names = hits.pop(node.lineno, None)
        if names is None:
            continue
        params = [
            p.arg for p in node.args.posonlyargs + node.args.args
        ]
        unknown = [nm for nm in names if nm not in params]
        if unknown:
            errors.append(
                (
                    node.lineno,
                    f"donates() annotation names {unknown} which are "
                    f"not positional parameters of {node.name}() "
                    f"(has {params})",
                )
            )
            continue
        specs[f"{mod.modname}.{node.name}"] = DonationSpec(
            frozenset(params.index(nm) for nm in names), tuple(params)
        )
    # Hits left over never matched a def line (e.g. a stray annotation
    # on a call site): also a declaration defect worth surfacing.
    errors.extend(
        (lineno, "donates() annotation is not on a function def line")
        for lineno in sorted(hits)
    )
    return specs, errors


def _donation_table(project) -> tuple:
    """``(merged table, {modname: [(lineno, message)]})``:
    KNOWN_DONATING overlaid by every module's ``donates()`` annotations.
    Built once per Project and memoized on it (rule instances are
    registry singletons; a cache across runs would go stale)."""
    cached = project.__dict__.get("_ba201_annotations")
    if cached is None:
        table = dict(KNOWN_DONATING)
        bad = {}
        for mod in project.modules.values():
            specs, errors = annotated_donations(mod)
            table.update(specs)
            if errors:
                bad[mod.modname] = errors
        cached = (table, bad)
        project.__dict__["_ba201_annotations"] = cached
    return cached


class _PoisonState(FlowState):
    def __init__(self, poisoned=None):
        # name -> (callee display, donate line)
        self.poisoned = dict(poisoned or {})

    def copy(self):
        return _PoisonState(self.poisoned)

    def merge(self, others):
        if not others:
            self.poisoned = {}
            return
        keep = {}
        for name, info in others[0].poisoned.items():
            if all(name in o.poisoned for o in others):
                keep[name] = self.poisoned.get(name, info)
        self.poisoned = keep


class _Handler(FlowHandler):
    def __init__(self, rule, mod, project, table):
        self.rule = rule
        self.mod = mod
        self.project = project
        self.table = table
        self.findings = {}

    def on_load(self, node, state):
        info = state.poisoned.get(node.id)
        if info is None:
            return
        callee, line = info
        key = (node.lineno, node.col_offset)
        if key not in self.findings:
            self.findings[key] = self.rule.finding(
                self.mod,
                node,
                f"'{node.id}' read after {callee} (line {line}) "
                "updated it in place: the carry is consumed (the "
                "static twin of pipeline.CarryConsumed); thread the "
                "returned value, or fresh_copy() before the dispatch",
            )

    def on_store(self, name, state):
        state.poisoned.pop(name, None)

    def on_call(self, call, state):
        spec = self.project.donation_for(
            self.mod, call.func, self.table
        )
        if spec is None:
            return
        callee = ast.unparse(call.func)
        for i in spec.positions:
            if i < len(call.args) and isinstance(call.args[i], ast.Name):
                state.poisoned[call.args[i].id] = (callee, call.lineno)
        named = spec.donated_params()
        for kw in call.keywords:
            if kw.arg in named and isinstance(kw.value, ast.Name):
                state.poisoned[kw.value.id] = (callee, call.lineno)


@register
class UseAfterDonate(Rule):
    code = "BA201"
    name = "use-after-donate"
    severity = "error"

    def check_module(self, mod, project):
        table, bad = _donation_table(project)
        for lineno, message in bad.get(mod.modname, ()):
            anchor = ast.Module(body=[], type_ignores=[])
            anchor.lineno, anchor.col_offset = lineno, 0
            yield self.finding(mod, anchor, message)
        handler = _Handler(self, mod, project, table)
        for _scope, body in function_scopes(mod.tree):
            walk_body(body, handler, _PoisonState())
        yield from handler.findings.values()
