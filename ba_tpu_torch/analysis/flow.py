"""A small intra-function dataflow walker shared by BA201 and BA202
(``ba_tpu/analysis/flow.py``).

Both rules are *must*-analyses over local names ("this name is
definitely donated/consumed here"), so they share one statement-ordered
event walk with false-positive-safe branch handling:

- Within a simple statement, events fire in evaluation order: the
  right-hand side of an assignment before its targets (so
  ``state = f(state)`` reads the old binding, then clears it), loads of
  a call's arguments before the call itself.
- ``if``/``try`` branches run on copies and merge by INTERSECTION — a
  fact must hold on every path to survive the join, so a consume inside
  one branch never poisons the fall-through path.
- Loop bodies run TWICE: the second pass re-enters with the first
  pass's exit state, which is what catches loop-carried bugs (consume
  at the bottom of the body, read at the top of the next iteration)
  without a fixpoint engine.  Rules de-duplicate findings by location, so the
  double walk never double-reports.
- ``lambda`` bodies and nested ``def``/``class`` are opaque: they
  execute later (or never), so their reads prove nothing about the
  enclosing function's statement order.  Nested functions are analyzed
  as their own scopes by the rule driver.

A rule implements :class:`FlowHandler` (``on_load`` / ``on_store`` /
``on_call``) over its own :class:`FlowState` subclass (``copy`` /
``merge``).
"""

from __future__ import annotations

import ast


class FlowState:
    """Rule-owned mutable state threaded through the walk."""

    def copy(self) -> "FlowState":
        raise NotImplementedError

    def merge(self, others: list) -> None:
        """Intersection-join ``others`` (branch exit states) into self."""
        raise NotImplementedError


class FlowHandler:
    """Event callbacks; rules collect findings on themselves."""

    def on_load(self, name_node: ast.Name, state: FlowState) -> None:
        pass

    def on_store(self, name: str, state: FlowState) -> None:
        pass

    def on_call(self, call: ast.Call, state: FlowState) -> None:
        pass


def walk_expr(node, handler: FlowHandler, state: FlowState) -> None:
    if node is None or isinstance(node, ast.Lambda):
        return
    if isinstance(node, ast.Call):
        walk_expr(node.func, handler, state)
        for a in node.args:
            walk_expr(a, handler, state)
        for kw in node.keywords:
            walk_expr(kw.value, handler, state)
        handler.on_call(node, state)
        return
    if isinstance(node, ast.Name):
        if isinstance(node.ctx, ast.Load):
            handler.on_load(node, state)
        else:
            handler.on_store(node.id, state)
        return
    if isinstance(node, ast.IfExp):
        walk_expr(node.test, handler, state)
        branches = []
        for side in (node.body, node.orelse):
            s = state.copy()
            walk_expr(side, handler, s)
            branches.append(s)
        state.merge(branches)
        return
    if isinstance(node, ast.BoolOp):
        # Short-circuit: operands after the first may never evaluate,
        # so each runs on a copy and joins by intersection — a donate
        # behind `flag and f(state)` must not poison the fall-through.
        walk_expr(node.values[0], handler, state)
        branches = [state.copy()]
        for value in node.values[1:]:
            s = state.copy()
            walk_expr(value, handler, s)
            branches.append(s)
        state.merge(branches)
        return
    for child in ast.iter_child_nodes(node):
        walk_expr(child, handler, state)


_MATCH = getattr(ast, "Match", None)


def _walk_pattern(pattern, handler: FlowHandler, state: FlowState) -> None:
    """Events for a match-case pattern: value/key expressions load,
    capture names (``case x``, ``case [*xs]``, ``case {**rest}``)
    store."""
    for node in ast.walk(pattern):
        if isinstance(node, ast.MatchValue):
            walk_expr(node.value, handler, state)
        elif isinstance(node, ast.MatchAs) and node.name:
            handler.on_store(node.name, state)
        elif isinstance(node, ast.MatchStar) and node.name:
            handler.on_store(node.name, state)
        elif isinstance(node, ast.MatchMapping):
            for key in node.keys:
                walk_expr(key, handler, state)
            if node.rest:
                handler.on_store(node.rest, state)
        elif isinstance(node, ast.MatchClass):
            walk_expr(node.cls, handler, state)


def _walk_loop(iter_events, body, orelse, handler, state) -> None:
    """Shared For/While shape: 0-iteration path merges with the
    double-walked body path."""
    zero_iter = state.copy()
    looped = state.copy()
    for _ in range(2):
        iter_events(looped)
        walk_body(body, handler, looped)
    # merge() computes the intersection of the given branch states, so
    # the 0-iteration path rides along explicitly.
    state.merge([zero_iter, looped])
    walk_body(orelse, handler, state)


def walk_stmt(stmt, handler: FlowHandler, state: FlowState) -> None:
    if isinstance(
        stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    ):
        for dec in stmt.decorator_list:
            walk_expr(dec, handler, state)
        # The def itself binds a name; its body is a separate scope.
        handler.on_store(stmt.name, state)
        return
    if isinstance(stmt, ast.If):
        walk_expr(stmt.test, handler, state)
        branches = []
        for body in (stmt.body, stmt.orelse):
            s = state.copy()
            walk_body(body, handler, s)
            branches.append(s)
        state.merge(branches)
        return
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        walk_expr(stmt.iter, handler, state)

        def events(s, _t=stmt.target):
            walk_expr(_t, handler, s)

        _walk_loop(events, stmt.body, stmt.orelse, handler, state)
        return
    if isinstance(stmt, ast.While):

        def events(s, _t=stmt.test):
            walk_expr(_t, handler, s)

        _walk_loop(events, stmt.body, stmt.orelse, handler, state)
        return
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            walk_expr(item.context_expr, handler, state)
            walk_expr(item.optional_vars, handler, state)
        walk_body(stmt.body, handler, state)
        return
    if _MATCH is not None and isinstance(stmt, _MATCH):
        walk_expr(stmt.subject, handler, state)
        # Arms are branches like `if`/`elif`: each runs on a copy
        # (capture patterns bind names, guards and bodies see them),
        # and the join keeps a no-arm-taken copy — `match` need not be
        # exhaustive.
        branches = [state.copy()]
        for case in stmt.cases:
            s = state.copy()
            _walk_pattern(case.pattern, handler, s)
            walk_expr(case.guard, handler, s)
            walk_body(case.body, handler, s)
            branches.append(s)
        state.merge(branches)
        return
    if isinstance(stmt, ast.Try):
        normal = state.copy()
        walk_body(stmt.body, handler, normal)
        walk_body(stmt.orelse, handler, normal)
        branches = [normal]
        for h in stmt.handlers:
            s = state.copy()
            if h.name:
                handler.on_store(h.name, s)
            walk_body(h.body, handler, s)
            branches.append(s)
        state.merge(branches)
        walk_body(stmt.finalbody, handler, state)
        return
    if isinstance(stmt, ast.Assign):
        walk_expr(stmt.value, handler, state)
        for t in stmt.targets:
            walk_expr(t, handler, state)
        return
    if isinstance(stmt, ast.AnnAssign):
        walk_expr(stmt.value, handler, state)
        walk_expr(stmt.target, handler, state)
        return
    if isinstance(stmt, ast.AugAssign):
        if isinstance(stmt.target, ast.Name):
            handler.on_load(stmt.target, state)
            walk_expr(stmt.value, handler, state)
            handler.on_store(stmt.target.id, state)
        else:
            walk_expr(stmt.target, handler, state)
            walk_expr(stmt.value, handler, state)
        return
    if isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                handler.on_store(t.id, state)
            else:
                walk_expr(t, handler, state)
        return
    # Expr / Return / Raise / Assert / Global / Import / pass ...: walk
    # whatever expressions hang off the node, in field order.
    for child in ast.iter_child_nodes(stmt):
        if isinstance(child, ast.expr):
            walk_expr(child, handler, state)


def walk_body(stmts, handler: FlowHandler, state: FlowState) -> None:
    for stmt in stmts:
        walk_stmt(stmt, handler, state)


def function_scopes(tree: ast.Module):
    """Every analyzable scope: the module body plus each (nested) def.

    Yields ``(scope_node, body)``; rules run their flow walk once per
    scope with fresh state, which is how lambda/def opacity in the walk
    stays sound — inner defs get their own pass.
    """
    yield tree, tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body
