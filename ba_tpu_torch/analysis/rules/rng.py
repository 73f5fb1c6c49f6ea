"""BA202 rng-key-reuse (``ba_tpu/analysis/rules/rng.py``, read for the
port's threefry draws).

Pass the same key to two draws and the "random" traitor coins repeat:
no crash, no warning, only correlated faults that break the independence
every histogram test assumes.  The engine's key discipline
(``fold_in(fold_in(base, counter + r), i)``) makes reuse impossible on
the hot path; this rule covers everywhere else.

The torch meaning, per function scope over the shared must-flow walk:

- A **draw** is a call of one of ``ba_tpu_torch/core/rng.py``'s
  sampling functions (:data:`SAMPLING`: ``bits``, ``coin_words``,
  ``coin_bits``, ``uniform_u8``, ``or_coin_threshold8``, ``randint``,
  ``uniform``), alias-resolved, with a bare-name key argument.  It
  consumes that name.
- A second draw from the same name before it is rebound is a finding.
  ``split`` and ``fold_in`` derive keys and consume nothing, and
  deriving in between (``k2 = rng.fold_in(key, 1)``) does not clear
  the mark: the key data is unchanged, so the original name still
  repeats its stream.  Only rebinding (``key = rng.fold_in(key, 1)``)
  decorrelates it.
- Branch joins are intersections; loop bodies are walked twice, so a
  loop-invariant key drawn from every iteration is caught.

Departure from the reference: draws from a ``torch.Generator`` (or the
global ``torch.manual_seed`` stream) are stateful, each call advancing
the generator, so a repeated generator name is no reuse and lies outside
the rule.  Only bare-name keys are tracked: ``rng.coin_bits(
rng.fold_in(key, i), shape)`` derives inline and is clean.  Deliberate
reuse (a test holding two implementations on the same randomness) is
what the line suppression is for::

    b = rng.coin_bits(key, (4,))  # ba-lint: disable=BA202 (same coins twice)
"""

from __future__ import annotations

import ast

from ba_tpu_torch.analysis.base import Rule, register
from ba_tpu_torch.analysis.flow import (
    FlowHandler,
    FlowState,
    function_scopes,
    walk_body,
)

RNG = "ba_tpu_torch.core.rng"
SAMPLING = {
    "bits", "coin_words", "coin_bits", "uniform_u8", "or_coin_threshold8",
    "randint", "uniform",
}
_KEY_NAMES = ("k", "key", "k_cnt")


def _key_arg(call: ast.Call):
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in _KEY_NAMES:
            return kw.value
    return None


class _ConsumedState(FlowState):
    def __init__(self, consumed=None):
        # name -> (sampling fn, line of first consumption)
        self.consumed = dict(consumed or {})

    def copy(self):
        return _ConsumedState(self.consumed)

    def merge(self, others):
        if not others:
            self.consumed = {}
            return
        keep = {}
        for name, info in others[0].consumed.items():
            if all(name in o.consumed for o in others):
                keep[name] = self.consumed.get(name, info)
        self.consumed = keep


class _Handler(FlowHandler):
    def __init__(self, rule, mod):
        self.rule = rule
        self.mod = mod
        self.findings = {}

    def on_store(self, name, state):
        state.consumed.pop(name, None)

    def on_call(self, call, state):
        dotted = self.mod.imports.resolve(call.func)
        if not dotted or not dotted.startswith(RNG + "."):
            return
        fn = dotted.rsplit(".", 1)[1]
        key = _key_arg(call)
        if fn not in SAMPLING or not isinstance(key, ast.Name):
            # Deriving calls (split/fold_in) deliberately do not clear
            # the mark: the original key would still repeat its stream.
            # Only on_store (rebinding) clears.
            return
        prior = state.consumed.get(key.id)
        if prior is not None:
            prev_fn, prev_line = prior
            loc = (call.lineno, call.col_offset)
            if loc not in self.findings:
                self.findings[loc] = self.rule.finding(
                    self.mod,
                    call,
                    f"key '{key.id}' already consumed by "
                    f"rng.{prev_fn} (line {prev_line}): reuse draws "
                    "identical randomness; split/fold_in first (or "
                    "rebind the name)",
                )
        else:
            state.consumed[key.id] = (fn, call.lineno)


@register
class RngKeyReuse(Rule):
    code = "BA202"
    name = "rng-key-reuse"
    severity = "error"

    def check_module(self, mod, project):
        handler = _Handler(self, mod)
        for _scope, body in function_scopes(mod.tree):
            walk_body(body, handler, _ConsumedState())
        yield from handler.findings.values()
