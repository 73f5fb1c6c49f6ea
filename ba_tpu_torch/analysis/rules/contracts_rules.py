"""BA6xx contracts: record schema, metric naming, environment reads
(``ba_tpu/analysis/rules/contracts_rules.py``, on the port's registry).

BA601 and BA602 consume ``ba_tpu_torch.analysis.contracts``, the port's
own registry.

- **BA601 record-schema**: every emit site the rule can read statically
  (a dict literal with a constant ``"event"`` key that spells ``"v"`` or
  goes straight into an ``.emit(...)`` call) is checked against
  :data:`contracts.RECORD_FAMILIES`: an unknown family is flagged (a
  misspelt event name makes a stream no consumer reads), and a site
  without a ``**spread`` must spell every required key.
- **BA602 metric-naming**: the ``serve_`` prefix and ``_per_shard``
  suffix rules at every ``counter`` / ``gauge`` / ``histogram``
  construction with a literal name, the static twin of
  ``obs/registry.MetricsRegistry``'s run-time assertion.
- **BA603 env-read**: the port reads no environment.  Any
  ``os.environ`` or ``os.getenv`` access, alias-resolved (a call, a
  subscript, a membership test, ``os.environ`` passed on whole), in the
  package or in ``chip_smoke.py`` is a finding.  It is the static twin
  of ``tests/test_torch_isolation.py::test_no_module_reads_the_environment``.
  *Departure from the reference:* the reference diffs its ``BA_TPU_*``
  reads against the README's table of knobs, both ways; the port's
  knobs are keywords (``ENV_DOCUMENTED`` is empty), so every read is a
  finding, whatever its name, and there is no unused-row direction.
  Tests are outside the rule: they set the reference's knobs and pass
  an environment on to subprocesses.
"""

from __future__ import annotations

import ast

from ba_tpu_torch.analysis import contracts
from ba_tpu_torch.analysis.base import Rule, register


def _dict_literal_keys(node: ast.Dict):
    keys = set()
    spread = False
    for k in node.keys:
        if k is None:
            spread = True
        elif isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
    return keys, spread


def _event_value(node: ast.Dict):
    for k, v in zip(node.keys, node.values):
        if (
            isinstance(k, ast.Constant)
            and k.value == "event"
            and isinstance(v, ast.Constant)
            and isinstance(v.value, str)
        ):
            return v.value
    return None


@register
class RecordSchema(Rule):
    code = "BA601"
    name = "record-schema"
    severity = "error"

    def check_module(self, mod, project):
        emit_args = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                is_emit = (
                    isinstance(fn, ast.Attribute) and fn.attr == "emit"
                ) or (isinstance(fn, ast.Name) and fn.id == "emit")
                if is_emit:
                    for arg in node.args:
                        if isinstance(arg, ast.Dict):
                            emit_args.add(id(arg))
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Dict):
                continue
            keys, spread = _dict_literal_keys(node)
            if "event" not in keys:
                continue
            if "v" not in keys and id(node) not in emit_args:
                # A dict that names an event but neither versions
                # itself nor flows into an emit() is a payload/filter,
                # not an emit site.
                continue
            event = _event_value(node)
            if event is None:
                continue  # dynamic event name; not statically checkable
            spec = contracts.RECORD_FAMILIES.get(event)
            if spec is None:
                yield self.finding(
                    mod,
                    node,
                    f"unknown record family {event!r}: not in "
                    f"analysis/contracts.RECORD_FAMILIES; a misspelt "
                    f"event name makes a JSONL stream no consumer reads "
                    f"(register the family or fix the name)",
                )
                continue
            if spread:
                continue  # keys may arrive through the **spread
            missing = [k for k in spec["required"] if k not in keys]
            if missing:
                yield self.finding(
                    mod,
                    node,
                    f"record family {event!r} emit site missing "
                    f"required key(s) {', '.join(sorted(missing))}: "
                    f"contracts.RECORD_FAMILIES declares them and its "
                    f"consumers key on every one",
                )


@register
class MetricNaming(Rule):
    code = "BA602"
    name = "metric-naming"
    severity = "error"

    _CTORS = {"counter", "gauge", "histogram"}

    def check_module(self, mod, project):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (
                isinstance(fn, ast.Attribute) and fn.attr in self._CTORS
            ):
                continue
            if not node.args:
                continue
            name_arg = node.args[0]
            if not (
                isinstance(name_arg, ast.Constant)
                and isinstance(name_arg.value, str)
            ):
                continue
            reason = contracts.metric_name_violation(name_arg.value)
            if reason:
                yield self.finding(mod, name_arg, reason)


ENV_SCOPE = ("ba_tpu_torch", "chip_smoke")
_ENV_OBJECTS = {"os.environ", "os.environb", "os.getenv", "os.getenvb"}


def _in_env_scope(modname: str) -> bool:
    return any(
        modname == s or modname.startswith(s + ".") for s in ENV_SCOPE
    )


@register
class EnvRead(Rule):
    code = "BA603"
    name = "env-read"
    severity = "error"

    def check_module(self, mod, project):
        if not _in_env_scope(mod.modname):
            return
        for node, dotted in mod.imports.resolved_refs(mod.tree):
            if any(
                dotted == o or dotted.startswith(o + ".")
                for o in _ENV_OBJECTS
            ):
                yield self.finding(
                    mod,
                    node,
                    f"{dotted} in the port: it reads no environment (the "
                    f"reference's knobs are keywords here); take the "
                    f"value as an argument",
                )
