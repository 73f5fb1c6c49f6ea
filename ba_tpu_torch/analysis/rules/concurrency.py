"""BA5xx concurrency: race and lock-discipline rules for the threaded
host tier (``ba_tpu/analysis/rules/concurrency.py``, carried over as it
is: the rules read pure ``threading``, which the port shares with the
reference).

The port's host tier has real threads: the pipeline's retire watchdog
(``parallel/pipeline._Watchdog``), the serving dispatcher, the run-id
hasher, ``shard_map``'s thread an entry and the health sampler's
lock-free reads.  Four rules check the invariants that keep them
correct:

- **BA501 unsynchronized-shared-mutation**: an instance attribute (or
  ``global``) written from more than one *thread context* —
  each discovered thread entry point is one context, the ordinary
  caller-facing API collectively another — must have a COMMON lock
  across every write (lock regions inferred from ``with <lock>``
  blocks, where a lock is anything assigned from
  ``threading.Lock/RLock/Condition``, alias-resolved).  Thread entry
  points are discovered from ``threading.Thread(target=...)``,
  ``threading.Timer(..., callback)`` and the
  ``# ba-lint: thread-entry`` annotation (for indirect dispatch the
  analyzer cannot see).  Writes in ``__init__`` are pre-thread and
  exempt.  Deliberate GIL-atomic single-writer patterns carry named
  inline suppressions.
- **BA502 lock-free-read discipline**: a module declaring
  ``# ba-lint: lockfree`` (``obs/health.py``'s sampler) may only perform
  single-opcode GIL-atomic reads of shared state: no read-modify-write
  on attributes/subscripts, no iteration over non-local containers, no
  lock acquisition at all.
- **BA503 lock-order-cycle**: the project-wide acquired-while-held
  graph (nested ``with`` regions plus one-hop ``self._m()`` calls made
  under a lock) must be acyclic; a cycle is a potential deadlock the
  moment two threads interleave.  Re-acquiring a NON-reentrant
  ``threading.Lock`` already held is reported as a self-cycle.
- **BA504 leaked-timer/daemon-lifecycle**: a ``threading.Timer`` armed
  in a function must be cancelled on ALL exits (a ``try/finally``
  cancel, or — when stored on ``self`` — a cancel somewhere in the
  owning class); a NON-daemon thread stored on ``self`` must be
  ``join()``\\ ed by the class (``stop()``/``close()``), else process
  exit hangs on it.

All pure ``ast`` and standard library, like the rest of the analyzer.
"""

from __future__ import annotations

import ast

from ba_tpu_torch.analysis.base import Rule, register

LOCK_CTORS = {
    "threading.Lock": False,  # value: reentrant?
    "threading.RLock": True,
    "threading.Condition": True,  # wraps an RLock by default
}
THREAD_CTOR = "threading.Thread"
TIMER_CTOR = "threading.Timer"


def _func_defs(body):
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _self_attr(node):
    """``self.X`` -> ``"X"`` (else None)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _call_thread_targets(call: ast.Call, imports):
    """(kind, callback-ast) for threading.Thread/Timer constructions.

    kind is "thread" or "timer"; callback is the ``target=`` /
    ``function`` argument's AST (None when absent).
    """
    fn = imports.resolve(call.func)
    if fn == THREAD_CTOR:
        for kw in call.keywords:
            if kw.arg == "target":
                return "thread", kw.value
        return "thread", None
    if fn == TIMER_CTOR:
        for kw in call.keywords:
            if kw.arg == "function":
                return "timer", kw.value
        if len(call.args) >= 2:
            return "timer", call.args[1]
        return "timer", None
    return None, None


def _own_nodes(scope):
    """All AST nodes of ``scope`` EXCLUDING subtrees of nested
    function/class definitions — those are separate scopes, visited
    when the walk reaches them as scopes of their own (without this a
    violation inside a closure would be reported once per enclosing
    def)."""
    nested = set()
    for f in ast.walk(scope):
        if f is scope:
            continue
        if isinstance(
            f, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            for sub in ast.walk(f):
                nested.add(id(sub))
    for node in ast.walk(scope):
        if id(node) not in nested:
            yield node


def _kw_daemon_true(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return (
                isinstance(kw.value, ast.Constant)
                and kw.value.value is True
            )
    return False


class _FuncFacts:
    """Guard-aware facts for ONE function body: attribute/global writes,
    ``self._m()`` calls, and lock acquisitions, each with the set of
    lock guards lexically active at that point.  Nested defs/lambdas
    are opaque (their own scopes)."""

    def __init__(self, func, lock_ids):
        # lock_ids: {guard-key: reentrant?} — "self.X" for instance
        # locks of the enclosing class, bare names for module locks.
        self.writes = []  # (attr, node, frozenset(guards)) for self.X
        self.global_writes = []  # (name, node, frozenset(guards))
        self.self_calls = []  # (method, node, frozenset(guards))
        self.acquires = []  # (guard-key, node, frozenset(held))
        self._locks = lock_ids
        self._globals = {
            n
            for stmt in ast.walk(func)
            if isinstance(stmt, ast.Global)
            for n in stmt.names
        }
        self._walk(func.body, frozenset())

    def _guard_key(self, expr):
        attr = _self_attr(expr)
        if attr is not None:
            key = f"self.{attr}"
            return key if key in self._locks else None
        if isinstance(expr, ast.Name) and expr.id in self._locks:
            return expr.id
        return None

    def _record_targets(self, targets, node, guards):
        stack = list(targets)
        while stack:
            t = stack.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                stack.extend(t.elts)
                continue
            if isinstance(t, ast.Starred):
                stack.append(t.value)
                continue
            attr = _self_attr(t)
            if attr is not None:
                self.writes.append((attr, node, guards))
            elif isinstance(t, ast.Name) and t.id in self._globals:
                self.global_writes.append((t.id, node, guards))

    def _walk(self, body, guards):
        for node in body:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue  # opaque nested scope
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = []
                held = set(guards)
                for item in node.items:
                    key = self._guard_key(item.context_expr)
                    if key is not None:
                        self.acquires.append(
                            (key, item.context_expr, frozenset(held))
                        )
                        held.add(key)
                        acquired.append(key)
                self._walk(node.body, frozenset(held))
                continue
            if isinstance(node, ast.Assign):
                self._record_targets(node.targets, node, guards)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if node.value is not None or isinstance(
                    node, ast.AugAssign
                ):
                    self._record_targets([node.target], node, guards)
            # self._m(...) calls (for entry-closure and BA503 one-hop).
            self._scan_calls(node, guards)
            for child_body_attr in ("body", "orelse", "finalbody"):
                child = getattr(node, child_body_attr, None)
                if child and not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    self._walk(child, guards)
            if isinstance(node, ast.Try):
                for h in node.handlers:
                    self._walk(h.body, guards)
            if isinstance(node, ast.Match):
                for case in node.cases:
                    self._walk(case.body, guards)

    def _scan_calls(self, stmt, guards):
        # Only the statement's own expressions — child statement lists
        # are walked structurally (so their guard context is right).
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.stmt) or isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    m = _self_attr(sub.func)
                    if m is not None:
                        self.self_calls.append((m, sub, guards))


class _ClassModel:
    """Per-class concurrency facts."""

    def __init__(self, cls: ast.ClassDef, mod):
        self.node = cls
        self.name = cls.name
        self.methods = {f.name: f for f in _func_defs(cls.body)}
        self.locks = {}  # "self.X" -> reentrant?
        for f in self.methods.values():
            for node in ast.walk(f):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    fn = mod.imports.resolve(node.value.func)
                    if fn in LOCK_CTORS:
                        for t in node.targets:
                            attr = _self_attr(t)
                            if attr is not None:
                                self.locks[f"self.{attr}"] = LOCK_CTORS[
                                    fn
                                ]
        self.facts = {
            name: _FuncFacts(f, self.locks)
            for name, f in self.methods.items()
        }
        # Thread entry points: target=self._m / Timer callbacks named
        # anywhere in the class, plus `# ba-lint: thread-entry`
        # annotations on def lines.
        self.entries = set()
        for f in self.methods.values():
            for node in ast.walk(f):
                if isinstance(node, ast.Call):
                    kind, cb = _call_thread_targets(node, mod.imports)
                    if kind and cb is not None:
                        attr = _self_attr(cb)
                        if attr is not None and attr in self.methods:
                            self.entries.add(attr)
        for name, f in self.methods.items():
            if "thread-entry" in mod.suppressions.annotations.get(
                f.lineno, ()
            ):
                self.entries.add(name)

    def entry_closure(self, entry):
        """Methods reachable from ``entry`` through self-calls, with
        the guard set accumulated along the FIRST discovery path."""
        out = {}
        stack = [(entry, frozenset())]
        while stack:
            name, inherited = stack.pop()
            if name in out or name not in self.facts:
                continue
            out[name] = inherited
            for callee, _node, guards in self.facts[name].self_calls:
                if callee in self.methods and callee not in out:
                    stack.append((callee, inherited | guards))
        return out


def _module_classes(mod):
    memo_key = "_ba5xx_classes"
    cache = mod.__dict__.setdefault(memo_key, None)
    if cache is None:
        cache = [
            _ClassModel(node, mod)
            for node in mod.tree.body
            if isinstance(node, ast.ClassDef)
        ]
        mod.__dict__[memo_key] = cache
    return cache


@register
class UnsynchronizedSharedMutation(Rule):
    code = "BA501"
    name = "unsynchronized-shared-mutation"
    severity = "error"

    def check_module(self, mod, project):
        for cm in _module_classes(mod):
            if not cm.entries:
                continue
            # attr -> {context: [(node, guards)]}
            by_attr: dict = {}
            entry_side = set()
            for entry in sorted(cm.entries):
                closure = cm.entry_closure(entry)
                entry_side |= set(closure)
                for method, inherited in closure.items():
                    for attr, node, guards in cm.facts[method].writes:
                        by_attr.setdefault(attr, {}).setdefault(
                            f"thread:{entry}", []
                        ).append((node, guards | inherited))
            for method, facts in cm.facts.items():
                if method in entry_side or method in (
                    "__init__",
                    "__new__",
                    "__del__",
                ):
                    continue
                for attr, node, guards in facts.writes:
                    by_attr.setdefault(attr, {}).setdefault(
                        "caller", []
                    ).append((node, guards))
            for attr in sorted(by_attr):
                contexts = by_attr[attr]
                if len(contexts) < 2:
                    continue
                all_writes = [
                    w for ws in contexts.values() for w in ws
                ]
                common = frozenset.intersection(
                    *[g for _n, g in all_writes]
                )
                if common:
                    continue
                # Anchor on the first unguarded (or least-guarded)
                # write, deterministic by location.
                anchor = min(
                    all_writes, key=lambda w: (len(w[1]), w[0].lineno)
                )[0]
                ctx_names = ", ".join(sorted(contexts))
                yield self.finding(
                    mod,
                    anchor,
                    f"attribute 'self.{attr}' of {cm.name} is written "
                    f"from multiple thread contexts ({ctx_names}) "
                    f"without a common lock — hold one `with <lock>` "
                    f"region around every write, or suppress with a "
                    f"named waiver if the single-writer/GIL-atomic "
                    f"pattern is deliberate",
                )


@register
class LockFreeReadDiscipline(Rule):
    code = "BA502"
    name = "lockfree-read-discipline"
    severity = "error"

    def check_module(self, mod, project):
        if "lockfree" not in mod.suppressions.file_annotations:
            return
        lock_names = self._module_locks(mod)
        for scope in ast.walk(mod.tree):
            if not isinstance(
                scope, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            local = self._local_names(scope)
            for node in _own_nodes(scope):
                if isinstance(node, ast.AugAssign) and isinstance(
                    node.target, (ast.Attribute, ast.Subscript)
                ):
                    yield self.finding(
                        mod,
                        node,
                        "read-modify-write on shared state in a "
                        "`# ba-lint: lockfree` module — `+=` on an "
                        "attribute/item is two interleavable opcodes, "
                        "not a GIL-atomic read",
                    )
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if self._is_lock(item.context_expr, mod,
                                         lock_names):
                            yield self.finding(
                                mod,
                                item.context_expr,
                                "lock acquisition in a "
                                "`# ba-lint: lockfree` module — the "
                                "module declares the no-lock read "
                                "discipline (health sampling must add "
                                "ZERO synchronization); move locked "
                                "work out or drop the declaration",
                            )
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ) and node.func.attr == "acquire":
                    yield self.finding(
                        mod,
                        node,
                        "explicit .acquire() in a "
                        "`# ba-lint: lockfree` module",
                    )
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    yield from self._check_iter(
                        mod, node.iter, local
                    )
                elif isinstance(
                    node,
                    (ast.ListComp, ast.SetComp, ast.DictComp,
                     ast.GeneratorExp),
                ):
                    for gen in node.generators:
                        yield from self._check_iter(
                            mod, gen.iter, local
                        )

    @staticmethod
    def _module_locks(mod):
        names = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if mod.imports.resolve(node.value.func) in LOCK_CTORS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
                        attr = _self_attr(t)
                        if attr is not None:
                            names.add(attr)
        return names

    @staticmethod
    def _is_lock(expr, mod, lock_names):
        if isinstance(expr, ast.Name) and expr.id in lock_names:
            return True
        if isinstance(expr, ast.Attribute) and expr.attr in lock_names:
            return True
        return False

    @staticmethod
    def _local_names(scope):
        local = {a.arg for a in scope.args.args}
        local |= {a.arg for a in scope.args.posonlyargs}
        local |= {a.arg for a in scope.args.kwonlyargs}
        # `self`/`cls` receivers are NOT local state: iterating
        # `self.table` walks the shared object, exactly what the
        # lock-free discipline forbids.
        local -= {"self", "cls"}
        for extra in (scope.args.vararg, scope.args.kwarg):
            if extra is not None:
                local.add(extra.arg)
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            local.add(n.id)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(node.target, ast.Name):
                    local.add(node.target.id)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        local.add(n.id)
            elif isinstance(node, ast.comprehension):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        local.add(n.id)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        for n in ast.walk(item.optional_vars):
                            if isinstance(n, ast.Name):
                                local.add(n.id)
        return local

    def _check_iter(self, mod, expr, local):
        root = self._iter_root(expr, local)
        if root is None:
            return
        yield self.finding(
            mod,
            expr,
            f"iteration over non-local container rooted at {root!r} "
            f"in a `# ba-lint: lockfree` module — a concurrent writer "
            f"mutating it mid-iteration raises RuntimeError or tears "
            f"the walk; snapshot into a local (e.g. "
            f"`list(...)` under the writer's lock) first",
        )

    def _iter_root(self, expr, local):
        """The non-local root name a (possibly chained/called) iterable
        reads from, or None when the iterable is provably local."""
        if isinstance(expr, (ast.Constant, ast.Tuple, ast.List,
                             ast.Set, ast.Dict)):
            return None
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name):
                # Builtins over their arguments: range(n),
                # enumerate(x), zip(a, b), sorted(x)...
                for arg in expr.args:
                    root = self._iter_root(arg, local)
                    if root is not None:
                        return root
                return None
            if isinstance(expr.func, ast.Attribute):
                # x.items() / self._d.values(): judge the receiver.
                return self._iter_root(expr.func.value, local)
            return None
        node = expr
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        if isinstance(node, ast.Name):
            return None if node.id in local else node.id
        return None


@register
class LockOrderCycle(Rule):
    code = "BA503"
    name = "lock-order-cycle"
    severity = "error"

    def check_module(self, mod, project):
        graph = self._project_graph(project)
        edges, reacquires = graph
        cyclic = self._cyclic_nodes(edges)
        for (a, b), sites in sorted(edges.items()):
            if a in cyclic and b in cyclic and cyclic[a] == cyclic[b]:
                for site_mod, node in sites:
                    if site_mod is mod:
                        members = sorted(
                            k for k, v in cyclic.items()
                            if v == cyclic[a]
                        )
                        yield self.finding(
                            mod,
                            node,
                            f"lock-order cycle: acquiring {b} while "
                            f"holding {a}, but elsewhere the order "
                            f"reverses (cycle members: "
                            f"{', '.join(members)}) — two threads "
                            f"interleaving these regions deadlock; "
                            f"pick ONE global order",
                        )
        for site_mod, node, lock in reacquires:
            if site_mod is mod:
                yield self.finding(
                    mod,
                    node,
                    f"re-acquiring non-reentrant lock {lock} while "
                    f"already holding it — this self-deadlocks the "
                    f"moment the path executes (use RLock, or lift "
                    f"the inner region out)",
                )

    def _project_graph(self, project):
        memo = project.__dict__.get("_ba503_graph")
        if memo is not None:
            return memo
        edges: dict = {}  # (lock_a, lock_b) -> [(mod, node)]
        reacquires = []  # (mod, node, lock)
        for m in project.modules.values():
            mod_locks = {}
            for node in m.tree.body:
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    fn = m.imports.resolve(node.value.func)
                    if fn in LOCK_CTORS:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                mod_locks[t.id] = LOCK_CTORS[fn]
            for cm in _module_classes(m):
                lock_kinds = dict(cm.locks)
                lock_kinds.update(mod_locks)

                def lock_id(key, cls=cm):
                    if key.startswith("self."):
                        return f"{m.modname}.{cls.name}.{key[5:]}"
                    return f"{m.modname}.{key}"

                for mname, facts in cm.facts.items():
                    for key, node, held in facts.acquires:
                        if key in held:
                            if not lock_kinds.get(key, True):
                                reacquires.append(
                                    (m, node, lock_id(key))
                                )
                            continue
                        for h in held:
                            edges.setdefault(
                                (lock_id(h), lock_id(key)), []
                            ).append((m, node))
                    # One-hop: self._m() under a lock, where _m
                    # acquires another lock at its own top level.
                    for callee, node, held in facts.self_calls:
                        if not held or callee not in cm.facts:
                            continue
                        for key, _n, inner_held in cm.facts[
                            callee
                        ].acquires:
                            if inner_held:
                                continue
                            if key in held:
                                if not lock_kinds.get(key, True):
                                    reacquires.append(
                                        (m, node, lock_id(key))
                                    )
                                continue
                            for h in held:
                                edges.setdefault(
                                    (lock_id(h), lock_id(key)), []
                                ).append((m, node))
            # Module-level functions with module locks.
            mod_lock_keys = {k: v for k, v in mod_locks.items()}
            for f in _func_defs(m.tree.body):
                facts = _FuncFacts(f, mod_lock_keys)
                for key, node, held in facts.acquires:
                    if key in held:
                        if not mod_lock_keys.get(key, True):
                            reacquires.append(
                                (m, node, f"{m.modname}.{key}")
                            )
                        continue
                    for h in held:
                        edges.setdefault(
                            (
                                f"{m.modname}.{h}",
                                f"{m.modname}.{key}",
                            ),
                            [],
                        ).append((m, node))
        memo = (edges, reacquires)
        project.__dict__["_ba503_graph"] = memo
        return memo

    @staticmethod
    def _cyclic_nodes(edges):
        """node -> SCC id, for nodes in a multi-node SCC (iterative
        Tarjan over the acquired-while-held digraph)."""
        adj: dict = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        index: dict = {}
        low: dict = {}
        on_stack: set = set()
        stack: list = []
        sccs: dict = {}
        counter = [0]
        scc_id = [0]

        for start in sorted(adj):
            if start in index:
                continue
            work = [(start, iter(adj[start]))]
            index[start] = low[start] = counter[0]
            counter[0] += 1
            stack.append(start)
            on_stack.add(start)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(adj[nxt])))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        for w in comp:
                            sccs[w] = scc_id[0]
                        scc_id[0] += 1
        return sccs


@register
class LeakedTimerLifecycle(Rule):
    code = "BA504"
    name = "leaked-timer-daemon-lifecycle"
    severity = "error"

    def check_module(self, mod, project):
        # Most modules start no thread or timer: one walk settles them.
        if not any(
            isinstance(n, ast.Call) and _call_thread_targets(n, mod.imports)[0]
            for n in ast.walk(mod.tree)
        ):
            return
        classes = {cm.name: cm for cm in _module_classes(mod)}
        for scope in ast.walk(mod.tree):
            if not isinstance(
                scope, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            owner = self._owning_class(mod, scope, classes)
            yield from self._check_scope(mod, scope, owner)

    @staticmethod
    def _owning_class(mod, scope, classes):
        for cm in classes.values():
            if scope.name in cm.methods and cm.methods[
                scope.name
            ] is scope:
                return cm
        return None

    def _check_scope(self, mod, scope, owner):
        finally_calls = self._finally_method_calls(scope)
        body_calls = self._method_calls(scope)
        for node in _own_nodes(scope):
            if not isinstance(node, ast.Call):
                continue
            kind, _cb = _call_thread_targets(node, mod.imports)
            if kind == "timer":
                yield from self._check_timer(
                    mod, scope, node, owner, finally_calls
                )
            elif kind == "thread":
                yield from self._check_thread(
                    mod, scope, node, owner, body_calls
                )

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _finally_method_calls(scope):
        """{(receiver, method)} called from any finally block."""
        out = set()
        for node in ast.walk(scope):
            if isinstance(node, ast.Try):
                for stmt in node.finalbody:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and isinstance(
                            sub.func, ast.Attribute
                        ):
                            recv = sub.func.value
                            if isinstance(recv, ast.Name):
                                out.add((recv.id, sub.func.attr))
                            else:
                                attr = _self_attr(recv)
                                if attr is not None:
                                    out.add(
                                        (f"self.{attr}", sub.func.attr)
                                    )
        return out

    @staticmethod
    def _method_calls(scope):
        out = set()
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ):
                recv = sub.func.value
                if isinstance(recv, ast.Name):
                    out.add((recv.id, sub.func.attr))
                else:
                    attr = _self_attr(recv)
                    if attr is not None:
                        out.add((f"self.{attr}", sub.func.attr))
        return out

    @staticmethod
    def _class_calls(owner, method):
        """{receiver-keys} on which ``method()`` is called anywhere in
        the owning class."""
        out = set()
        if owner is None:
            return out
        for f in owner.methods.values():
            for sub in ast.walk(f):
                if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute
                ) and sub.func.attr == method:
                    attr = _self_attr(sub.func.value)
                    if attr is not None:
                        out.add(f"self.{attr}")
        return out

    def _binding_of(self, scope, call):
        """('local', name) / ('attr', attr) / ('chained', None) /
        (None, None) for how a Thread/Timer construction is bound."""
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and node.value is call:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        return "local", t.id
                    attr = _self_attr(t)
                    if attr is not None:
                        return "attr", attr
                return "other", None
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.value is call
            ):
                return "chained", node.func.attr
            if isinstance(node, ast.Call) and call in node.args:
                return "escapes", None
            if isinstance(node, (ast.Return, ast.Yield)) and getattr(
                node, "value", None
            ) is call:
                return "escapes", None
        return None, None

    def _check_timer(self, mod, scope, call, owner, finally_calls):
        how, name = self._binding_of(scope, call)
        if how == "chained":
            if name == "start":
                yield self.finding(
                    mod,
                    call,
                    "threading.Timer(...).start() with no binding — "
                    "the timer can never be cancelled; bind it and "
                    "cancel on every exit (try/finally)",
                )
            return
        if how == "escapes" or how == "other":
            return  # lifecycle handed elsewhere; not provable here
        if how == "local":
            started = (name, "start") in self._method_calls(scope)
            if not started:
                return
            if (name, "cancel") in finally_calls:
                return
            yield self.finding(
                mod,
                call,
                f"threading.Timer bound to {name!r} is started but "
                f"not cancelled on all exits — wrap the armed region "
                f"in try/finally with {name}.cancel() in the finally "
                f"(an exception between start() and the hot path "
                f"leaks a live timer that fires into torn state)",
            )
            return
        if how == "attr":
            cancels = self._class_calls(owner, "cancel")
            if f"self.{name}" in cancels:
                return
            yield self.finding(
                mod,
                call,
                f"threading.Timer stored on self.{name} is never "
                f"cancelled anywhere in "
                f"{owner.name if owner else 'this class'} — add a "
                f"cancel on the stop/close path (a live timer "
                f"outliving its owner fires into torn state)",
            )

    def _check_thread(self, mod, scope, call, owner, body_calls):
        if _kw_daemon_true(call):
            return
        how, name = self._binding_of(scope, call)
        if how == "chained":
            return
        if how in ("escapes", "other", None):
            return
        # `t.daemon = True` after construction also counts.
        if how == "local" and self._daemon_assigned(scope, name):
            return
        if how == "attr" and owner is not None and any(
            self._daemon_assigned(f, f"self.{name}")
            for f in owner.methods.values()
        ):
            return
        if how == "local":
            if (name, "start") not in body_calls:
                return
            if (name, "join") in body_calls:
                return
            yield self.finding(
                mod,
                call,
                f"non-daemon thread {name!r} is started but never "
                f"joined in this function — process exit blocks on "
                f"it; join it, or mark it daemon=True if abandoning "
                f"mid-work is safe",
            )
            return
        if how == "attr":
            joins = self._class_calls(owner, "join")
            if f"self.{name}" in joins:
                return
            yield self.finding(
                mod,
                call,
                f"non-daemon thread stored on self.{name} is never "
                f"join()ed anywhere in "
                f"{owner.name if owner else 'this class'} — add a "
                f"join to stop()/close(), or mark it daemon=True",
            )

    @staticmethod
    def _daemon_assigned(scope, key):
        """True when `<key>.daemon = True` appears in ``scope`` (key is
        a bare local name or 'self.attr')."""
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Constant)
                and node.value.value is True
            ):
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "daemon"
                ):
                    recv = t.value
                    if isinstance(recv, ast.Name) and recv.id == key:
                        return True
                    attr = _self_attr(recv)
                    if attr is not None and f"self.{attr}" == key:
                        return True
        return False
