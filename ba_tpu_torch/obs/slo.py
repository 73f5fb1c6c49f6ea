"""The streaming SLO engine (``ba_tpu/obs/slo.py``): per-phase latency
attribution, per-tenant accounting, error-budget burn rates and an
autoscaling signal over the serving tier's ``request`` records.

- **Attribution.**  Every request decomposes into ``queue_s`` /
  ``coalesce_s`` / ``compile_s`` / ``dispatch_s`` / ``retire_lag_s``,
  whose sum telescopes to ``wall_s`` within :data:`ATTRIB_TOL_S` (the
  service stamps the marks, ``runtime/serve.py``; the engine aggregates
  and checks).  Phase distributions are kept per ``(cohort, tenant)`` in
  the registry's log-bucketed ``Histogram`` (O(1) memory a group),
  quantiles by ``registry.delta_quantile``, the health sampler's own.
- **Error budgets and burn rates** (multi-window): an
  :class:`SLOObjective` names a latency threshold, a target fraction and
  three windows (fast / slow / budget).  ``burn = (bad / total) / (1 -
  target)`` a window; an alert fires when both the fast and the slow
  window burn at or above ``burn_threshold`` and clears when either drops
  below.  Good and bad events live in time-bucketed rings.
- **No wait on the card.**  The engine never touches a device.  Reports
  ride the health sampler's cadence (``HealthSampler.sample`` calls
  :meth:`SLOEngine.maybe_report` on the installed engine).
- **Records out**, run-id stamped and strict JSON: ``slo_report``,
  ``slo_alert`` (transitions only) and ``autoscale_signal`` (queue
  pressure and burn to a replica count); the gauges ``health_slo_burn``
  (the worst gate burn) and ``health_slo_worst_p99_s``, which the shed
  ladder and the REPL's ``stats --live`` read.

The policy format is the JAX package's (``"ba_tpu.slo_policy"`` v1), so
one policy file serves both packages.  The reference's ``BA_TPU_SLO``
variable is ``ServeConfig(slo=)``.  Stdlib only: ``python -m
ba_tpu_torch.obs.slo`` validates policies and renders offline reports
without torch.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time

from ba_tpu_torch.obs import flight as _flight
from ba_tpu_torch.obs import registry as _registry
from ba_tpu_torch.utils import metrics as _metrics

POLICY_FORMAT = "ba_tpu.slo_policy"
POLICY_VERSION = 1

# The five attribution phases, in lifecycle order.  Their sum must
# telescope to wall_s (admitted → delivered) within ATTRIB_TOL_S — the
# service stamps consecutive perf_counter marks, so the identity is
# exact modulo record rounding (6 dp per field).
PHASES = ("queue_s", "coalesce_s", "compile_s", "dispatch_s", "retire_lag_s")
ATTRIB_TOL_S = 2e-3

# Hard cap on distinct (cohort, tenant) groups: the engine is O(1) per
# group, but tenants are caller-controlled strings — past the cap, new
# groups fold into one overflow bucket instead of growing without bound.
MAX_GROUPS = 64
OVERFLOW_GROUP = ("~other", "~other")


class SLOPolicyError(ValueError):
    """A policy document failed eager validation."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SLOPolicyError(msg)


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One latency objective: ``target`` fraction of matched requests
    must complete (status ok) within ``latency_s``, measured against an
    error budget over ``window_s``.  ``tenant`` / ``cohort`` / ``kind``
    select which requests count (None = all); a rejected or expired
    request always counts bad.  Plain data, eagerly validated."""

    name: str
    latency_s: float
    target: float = 0.99
    window_s: float = 3600.0
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_threshold: float = 8.0
    tenant: str | None = None
    cohort: str | None = None
    kind: str | None = None

    def __post_init__(self):
        _require(
            bool(self.name) and isinstance(self.name, str),
            "objective name must be a non-empty string",
        )
        _require(
            isinstance(self.latency_s, (int, float)) and self.latency_s > 0,
            f"objective {self.name!r}: latency_s must be > 0",
        )
        _require(
            isinstance(self.target, (int, float)) and 0 < self.target < 1,
            f"objective {self.name!r}: target must be in (0, 1)",
        )
        for field in ("window_s", "fast_window_s", "slow_window_s"):
            v = getattr(self, field)
            _require(
                isinstance(v, (int, float)) and v > 0,
                f"objective {self.name!r}: {field} must be > 0",
            )
        _require(
            self.fast_window_s <= self.slow_window_s <= self.window_s,
            f"objective {self.name!r}: windows must nest "
            f"(fast_window_s <= slow_window_s <= window_s)",
        )
        _require(
            isinstance(self.burn_threshold, (int, float))
            and self.burn_threshold > 0,
            f"objective {self.name!r}: burn_threshold must be > 0",
        )
        for field in ("tenant", "cohort", "kind"):
            v = getattr(self, field)
            _require(
                v is None or (isinstance(v, str) and v),
                f"objective {self.name!r}: {field} must be None or a "
                f"non-empty string",
            )

    def matches(self, cohort: str, tenant: str, kind) -> bool:
        if self.tenant is not None and self.tenant != tenant:
            return False
        if self.cohort is not None and self.cohort != cohort:
            return False
        if self.kind is not None and self.kind != kind:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """A set of objectives plus engine dials.  JSON round-trips through
    :meth:`to_doc` / :meth:`from_doc` under the pinned
    ``{"format": "ba_tpu.slo_policy", "v": 1}`` header."""

    objectives: tuple = ()
    report_every_s: float = 1.0
    autoscale: bool = True
    max_replicas: int = 8

    def __post_init__(self):
        _require(
            len(self.objectives) >= 1,
            "policy needs at least one objective",
        )
        names = [o.name for o in self.objectives]
        _require(
            len(names) == len(set(names)),
            f"objective names must be unique, got {names}",
        )
        _require(
            isinstance(self.report_every_s, (int, float))
            and self.report_every_s > 0,
            "report_every_s must be > 0",
        )
        _require(
            isinstance(self.max_replicas, int) and self.max_replicas >= 1,
            "max_replicas must be an int >= 1",
        )

    def to_doc(self) -> dict:
        return {
            "format": POLICY_FORMAT,
            "v": POLICY_VERSION,
            "report_every_s": self.report_every_s,
            "autoscale": self.autoscale,
            "max_replicas": self.max_replicas,
            "objectives": [
                {
                    k: v
                    for k, v in dataclasses.asdict(o).items()
                    if v is not None
                }
                for o in self.objectives
            ],
        }

    @classmethod
    def from_doc(cls, doc) -> "SLOPolicy":
        _require(isinstance(doc, dict), "policy document must be an object")
        _require(
            doc.get("format") == POLICY_FORMAT,
            f"policy format must be {POLICY_FORMAT!r}, "
            f"got {doc.get('format')!r}",
        )
        _require(
            doc.get("v") == POLICY_VERSION,
            f"policy version must be {POLICY_VERSION}, got {doc.get('v')!r}",
        )
        objs = doc.get("objectives")
        _require(
            isinstance(objs, list) and objs,
            "policy objectives must be a non-empty list",
        )
        allowed_obj = {f.name for f in dataclasses.fields(SLOObjective)}
        built = []
        for i, o in enumerate(objs):
            _require(
                isinstance(o, dict), f"objective #{i} must be an object"
            )
            unknown = set(o) - allowed_obj
            _require(
                not unknown,
                f"objective #{i} has unknown keys {sorted(unknown)}",
            )
            built.append(SLOObjective(**o))
        allowed_top = {
            "format",
            "v",
            "objectives",
            "report_every_s",
            "autoscale",
            "max_replicas",
        }
        unknown = set(doc) - allowed_top
        _require(not unknown, f"policy has unknown keys {sorted(unknown)}")
        kwargs = {}
        for k in ("report_every_s", "autoscale", "max_replicas"):
            if k in doc:
                kwargs[k] = doc[k]
        return cls(objectives=tuple(built), **kwargs)

    @classmethod
    def load(cls, path: str) -> "SLOPolicy":
        with open(path, encoding="utf-8") as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise SLOPolicyError(f"{path}: not valid JSON — {e}") from e
        return cls.from_doc(doc)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_doc(), f, indent=2, sort_keys=True)
            f.write("\n")


def default_policy() -> SLOPolicy:
    """The policy ``ServeConfig(slo=True)`` installs: one catch-all
    wall-latency objective with SRE-workbook-shaped windows, scaled for
    interactive serving."""
    return SLOPolicy(
        objectives=(
            SLOObjective(
                name="serve-wall",
                latency_s=0.5,
                target=0.99,
                window_s=3600.0,
                fast_window_s=60.0,
                slow_window_s=600.0,
                burn_threshold=8.0,
            ),
        ),
        report_every_s=1.0,
    )


def recommend_replicas(
    queue_frac,
    burn,
    replicas: int = 1,
    max_replicas: int = 8,
) -> tuple:
    """Pure replica-count recommendation from queue pressure + gate
    burn — the ``autoscale_signal`` contract a fleet router consumes.
    Returns ``(recommended, reason)``.

    Ladder (first match wins; None inputs read as no pressure):

    - burn ≥ 2×threshold-normalized (i.e. ``burn >= 2``) or queue ≥
      87.5% full → double (budget is burning fast or admission is about
      to shed);
    - burn ≥ 1 or queue ≥ 50% → +1 replica;
    - burn < 0.5 and queue < 25% → −1 replica (scale-in, floor 1);
    - otherwise hold.
    """
    qf = 0.0 if queue_frac is None else float(queue_frac)
    b = 0.0 if burn is None else float(burn)
    if b >= 2.0 or qf >= 0.875:
        reason = "burn_hard" if b >= 2.0 else "queue_hard"
        return min(max_replicas, max(replicas * 2, replicas + 1)), reason
    if b >= 1.0 or qf >= 0.5:
        reason = "burn_soft" if b >= 1.0 else "queue_soft"
        return min(max_replicas, replicas + 1), reason
    if b < 0.5 and qf < 0.25 and replicas > 1:
        return replicas - 1, "decay"
    return replicas, "steady"


class _WindowRing:
    """Good/bad event counts over a sliding time window in O(buckets)
    memory: ``n_slots`` time buckets of ``window_s / n_slots`` seconds,
    each ``[epoch_index, good, bad]``; a slot is lazily reset when its
    epoch comes round again, so no timer thread and no per-event
    allocation."""

    def __init__(self, window_s: float, n_slots: int = 12):
        self.window_s = float(window_s)
        self.width = self.window_s / n_slots
        self._slots = [[None, 0, 0] for _ in range(n_slots)]

    def _slot(self, t: float):
        epoch = int(t // self.width)
        slot = self._slots[epoch % len(self._slots)]
        if slot[0] != epoch:
            slot[0] = epoch
            slot[1] = 0
            slot[2] = 0
        return slot

    def add(self, t: float, good: int = 0, bad: int = 0) -> None:
        slot = self._slot(t)
        slot[1] += good
        slot[2] += bad

    def totals(self, t: float) -> tuple:
        """(good, bad) over the window ending at ``t``."""
        lo = int(t // self.width) - len(self._slots) + 1
        good = bad = 0
        for epoch, g, b in self._slots:
            if epoch is not None and epoch >= lo:
                good += g
                bad += b
        return good, bad


class _Group:
    """Per-(cohort, tenant) streaming state: one log-bucketed histogram
    per phase plus wall, outcome/reject tallies, and the per-report
    peek baselines the windowed quantiles difference against."""

    def __init__(self, lock):
        self.hists = {
            name: _registry.Histogram(lock) for name in PHASES + ("wall_s",)
        }
        self.baselines = {name: None for name in self.hists}
        self.counts = {"ok": 0, "failed": 0, "expired": 0, "rejected": 0}
        self.reject_reasons: dict = {}
        self.kinds: set = set()
        self.attribution_checked = 0
        self.attribution_bad = 0
        self.window_events = 0


class _Objective:
    """An :class:`SLOObjective` plus its three live rings."""

    def __init__(self, spec: SLOObjective):
        self.spec = spec
        self.fast = _WindowRing(spec.fast_window_s)
        self.slow = _WindowRing(spec.slow_window_s)
        self.budget = _WindowRing(spec.window_s, n_slots=24)
        self.alerting = False


def _burn(good: int, bad: int, target: float):
    """SRE burn rate: observed bad fraction over the window divided by
    the budgeted bad fraction.  None on an empty window (no data is not
    the same as healthy)."""
    total = good + bad
    if not total:
        return None
    return (bad / total) / (1.0 - target)


def _num(v):
    """Strict-JSON scalar: quantile walks return inf for the overflow
    bucket; records carry null instead (json.dumps would emit the bare
    token ``Infinity``, which strict consumers reject)."""
    if v is None or v == float("inf"):
        return None
    return round(float(v), 6)


class SLOEngine:
    """Folds ``request`` / ``admission`` records into per-group phase
    distributions and per-objective burn windows; emits ``slo_report``
    / ``slo_alert`` / ``autoscale_signal`` records on demand.

    Thread-safety: :meth:`fold` takes the engine lock (it is called
    from the service's dispatcher/submit threads); :meth:`maybe_report`
    takes it too, briefly, to snapshot.  Nothing in here ever touches a
    device or takes the metrics-registry lock — gauge writes go through
    the registry's instrument API, reads through lock-free ``get``.
    """

    def __init__(self, policy: SLOPolicy, registry=None, clock=None):
        self.policy = policy
        self._registry = registry
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._hist_lock = threading.Lock()
        self._groups: dict = {}
        self._objectives = [_Objective(o) for o in policy.objectives]
        self._last_report_t: float | None = None
        self.reports = 0
        self.queue_frac = None  # service-stamped, GIL-atomic write/read
        self.replicas = 1
        self.last_worst = None  # REPL-readable summary of the last report
        fingerprint = json.dumps(policy.to_doc(), sort_keys=True)
        self.run_id = _flight.resolve_run_id("slo", fingerprint)

    def _reg(self):
        return (
            self._registry
            if self._registry is not None
            else _registry.default_registry()
        )

    def _group(self, cohort: str, tenant: str) -> _Group:
        key = (cohort, tenant)
        g = self._groups.get(key)
        if g is None:
            if len(self._groups) >= MAX_GROUPS:
                key = OVERFLOW_GROUP
                g = self._groups.get(key)
                if g is None:
                    g = self._groups[key] = _Group(self._hist_lock)
                return g
            g = self._groups[key] = _Group(self._hist_lock)
        return g

    # ------------------------------------------------------------------
    # Fold

    def fold(self, rec: dict, t: float | None = None) -> None:
        """Consume one JSONL record dict.  Only ``request`` and
        rejected ``admission`` records count; everything else is
        ignored, so a caller may pipe the whole stream through."""
        event = rec.get("event")
        if event == "request":
            self._fold_request(rec, t)
        elif event == "admission" and rec.get("decision") == "reject":
            self._fold_reject(rec, t)

    def _fold_request(self, rec: dict, t: float | None) -> None:
        now = self._clock() if t is None else t
        status = rec.get("status")
        cohort = rec.get("cohort") or "-"
        tenant = rec.get("tenant") or "-"
        kind = rec.get("kind")
        wall = rec.get("wall_s")
        with self._lock:
            g = self._group(cohort, tenant)
            g.window_events += 1
            if kind:
                g.kinds.add(kind)
            if status in g.counts:
                g.counts[status] += 1
            if isinstance(wall, (int, float)):
                g.hists["wall_s"].record(wall)
            phase_sum = 0.0
            phases_seen = 0
            for name in PHASES:
                v = rec.get(name)
                if isinstance(v, (int, float)):
                    g.hists[name].record(v)
                    phase_sum += v
                    phases_seen += 1
            # The attribution invariant is only claimed for ok rows:
            # every phase stamped, sum telescopes to wall.
            if (
                status == "ok"
                and phases_seen == len(PHASES)
                and isinstance(wall, (int, float))
            ):
                g.attribution_checked += 1
                if abs(phase_sum - wall) > ATTRIB_TOL_S:
                    g.attribution_bad += 1
            good_if_fast = status == "ok" and isinstance(wall, (int, float))
            for obj in self._objectives:
                if not obj.spec.matches(cohort, tenant, kind):
                    continue
                good = good_if_fast and wall <= obj.spec.latency_s
                obj.fast.add(now, good=int(good), bad=int(not good))
                obj.slow.add(now, good=int(good), bad=int(not good))
                obj.budget.add(now, good=int(good), bad=int(not good))

    def _fold_reject(self, rec: dict, t: float | None) -> None:
        now = self._clock() if t is None else t
        cohort = rec.get("cohort") or "-"
        tenant = rec.get("tenant") or "-"
        reason = rec.get("reason") or "unknown"
        kind = rec.get("kind")
        with self._lock:
            g = self._group(cohort, tenant)
            g.window_events += 1
            g.counts["rejected"] += 1
            g.reject_reasons[reason] = g.reject_reasons.get(reason, 0) + 1
            for obj in self._objectives:
                if obj.spec.matches(cohort, tenant, kind):
                    obj.fast.add(now, bad=1)
                    obj.slow.add(now, bad=1)
                    obj.budget.add(now, bad=1)

    # ------------------------------------------------------------------
    # Report

    def maybe_report(self, now=None, sink=None, force: bool = False):
        """Emit one ``slo_report`` (plus any alert transitions and an
        ``autoscale_signal``) if ``report_every_s`` has elapsed since
        the last one.  Returns the report record, or None when not due.
        Called on the health sampler's cadence — never from a device
        callback, never blocking on anything."""
        now = self._clock() if now is None else now
        if (
            not force
            and self._last_report_t is not None
            and now - self._last_report_t < self.policy.report_every_s
        ):
            return None
        out_sink = sink or _metrics.default_sink()
        with self._lock:
            # Alerts first, so the report's per-objective ``alerting``
            # flag reflects THIS tick's fire/clear decision.
            alerts = self._update_alerts(now)
            report = self._build_report(now)
            self._last_report_t = now
            self.reports += 1
        for alert in alerts:
            out_sink.emit(alert)
        out_sink.emit(report)
        if self.policy.autoscale:
            out_sink.emit(self._autoscale_signal(report))
        self._write_gauges(report)
        return report

    def _build_report(self, now: float) -> dict:
        groups = []
        worst_p99 = None
        worst_group = None
        for (cohort, tenant), g in sorted(self._groups.items()):
            phases = {}
            for name, hist in g.hists.items():
                peek = hist.peek()
                p50 = _registry.delta_quantile(
                    hist, g.baselines[name], peek["counts"], 0.5
                )
                p99 = _registry.delta_quantile(
                    hist, g.baselines[name], peek["counts"], 0.99
                )
                g.baselines[name] = peek["counts"]
                phases[name] = {"p50": _num(p50), "p99": _num(p99)}
            wall_p99 = phases["wall_s"]["p99"]
            if wall_p99 is not None and (
                worst_p99 is None or wall_p99 > worst_p99
            ):
                worst_p99 = wall_p99
                dominant = max(
                    PHASES,
                    key=lambda n: (phases[n]["p99"] or 0.0),
                )
                worst_group = {
                    "cohort": cohort,
                    "tenant": tenant,
                    "p99_s": wall_p99,
                    "phase": dominant,
                }
            groups.append(
                {
                    "cohort": cohort,
                    "tenant": tenant,
                    "window_events": g.window_events,
                    "counts": dict(g.counts),
                    "reject_reasons": dict(g.reject_reasons),
                    "phases": phases,
                    "attribution_checked": g.attribution_checked,
                    "attribution_bad": g.attribution_bad,
                }
            )
            g.window_events = 0
        objectives = []
        worst_burn = None
        for obj in self._objectives:
            fg, fb = obj.fast.totals(now)
            sg, sb = obj.slow.totals(now)
            bg, bb = obj.budget.totals(now)
            burn_fast = _burn(fg, fb, obj.spec.target)
            burn_slow = _burn(sg, sb, obj.spec.target)
            # The GATE burn: the multi-window alert fires on min(fast,
            # slow) — fast alone is noise, slow alone is stale — so the
            # scalar the shed ladder / autoscaler reads is that min.
            gate = None
            if burn_fast is not None and burn_slow is not None:
                gate = min(burn_fast, burn_slow)
            budget_remaining = None
            if bg + bb:
                budget_remaining = 1.0 - (bb / (bg + bb)) / (
                    1.0 - obj.spec.target
                )
            if gate is not None and (worst_burn is None or gate > worst_burn):
                worst_burn = gate
            objectives.append(
                {
                    "name": obj.spec.name,
                    "target": obj.spec.target,
                    "latency_s": obj.spec.latency_s,
                    "good": bg,
                    "bad": bb,
                    "burn_fast": _num(burn_fast),
                    "burn_slow": _num(burn_slow),
                    "burn": _num(gate),
                    "budget_remaining": _num(budget_remaining),
                    "alerting": obj.alerting,
                }
            )
        self.last_worst = (
            None
            if worst_group is None
            else {**worst_group, "burn": _num(worst_burn)}
        )
        return {
            "event": "slo_report",
            "v": _metrics.SCHEMA_VERSION,
            "run_id": self.run_id,
            "groups": groups,
            "objectives": objectives,
            "worst_burn": _num(worst_burn),
            "worst_p99_s": _num(worst_p99),
        }

    def _update_alerts(self, now: float) -> list:
        """Fire/clear transitions since the last report — emitted as
        ``slo_alert`` records, transitions only (steady state is the
        report's ``alerting`` flag)."""
        alerts = []
        for obj in self._objectives:
            fg, fb = obj.fast.totals(now)
            sg, sb = obj.slow.totals(now)
            burn_fast = _burn(fg, fb, obj.spec.target)
            burn_slow = _burn(sg, sb, obj.spec.target)
            both_hot = (
                burn_fast is not None
                and burn_slow is not None
                and burn_fast >= obj.spec.burn_threshold
                and burn_slow >= obj.spec.burn_threshold
            )
            if both_hot != obj.alerting:
                obj.alerting = both_hot
                alerts.append(
                    {
                        "event": "slo_alert",
                        "v": _metrics.SCHEMA_VERSION,
                        "run_id": self.run_id,
                        "objective": obj.spec.name,
                        "state": "fire" if both_hot else "clear",
                        "burn_fast": _num(burn_fast),
                        "burn_slow": _num(burn_slow),
                        "threshold": obj.spec.burn_threshold,
                    }
                )
        return alerts

    def _autoscale_signal(self, report: dict) -> dict:
        qf = self.queue_frac
        burn = report.get("worst_burn")
        recommended, reason = recommend_replicas(
            qf, burn, self.replicas, self.policy.max_replicas
        )
        return {
            "event": "autoscale_signal",
            "v": _metrics.SCHEMA_VERSION,
            "run_id": self.run_id,
            "queue_frac": _num(qf),
            "burn": burn,
            "replicas": self.replicas,
            "recommended": recommended,
            "reason": reason,
        }

    def _write_gauges(self, report: dict) -> None:
        reg = self._reg()
        burn = report.get("worst_burn")
        # An empty fast window (no traffic) reads as ZERO burn, never a
        # held-over stale value: a last-write-wins gauge that kept the
        # burst's peak would pin the shed ladder at tier 2 after the
        # storm has long drained.
        reg.gauge("health_slo_burn").set(burn if burn is not None else 0.0)
        p99 = report.get("worst_p99_s")
        if p99 is not None:
            reg.gauge("health_slo_worst_p99_s").set(p99)


# ----------------------------------------------------------------------
# Process-wide installation (the health sampler's hook target)

_installed: SLOEngine | None = None


def install(engine: SLOEngine | None) -> SLOEngine | None:
    """Install ``engine`` as the process-wide SLO engine (None
    uninstalls).  The health sampler invokes ``maybe_report`` on the
    installed engine after every sample; the serving front-end folds
    its request/admission records into it.  Returns the engine."""
    global _installed
    _installed = engine
    return engine


def installed() -> SLOEngine | None:
    return _installed


# ----------------------------------------------------------------------
# CLI — torch-free, like the scenario CLI:
#   python -m ba_tpu_torch.obs.slo validate <policy.json> ...
#   python -m ba_tpu_torch.obs.slo default [out.json]
#   python -m ba_tpu_torch.obs.slo report <records.jsonl> [policy.json]


def _cli_validate(paths) -> int:
    if not paths:
        print("validate: needs at least one policy path", file=sys.stderr)
        return 2
    rc = 0
    for path in paths:
        try:
            policy = SLOPolicy.load(path)
        except (OSError, SLOPolicyError) as e:
            print(f"{path}: FAIL — {e}", file=sys.stderr)
            rc = 1
            continue
        # Round-trip pin: to_doc(from_doc(doc)) must be a fixed point.
        again = SLOPolicy.from_doc(policy.to_doc())
        if again != policy:
            print(f"{path}: FAIL — round-trip not a fixed point")
            rc = 1
            continue
        print(
            f"{path}: OK — {len(policy.objectives)} objective(s), "
            f"report every {policy.report_every_s}s"
        )
    return rc


def _cli_default(argv) -> int:
    doc = default_policy().to_doc()
    text = json.dumps(doc, indent=2, sort_keys=True)
    if argv:
        with open(argv[0], "w", encoding="utf-8") as f:
            f.write(text + "\n")
        print(f"wrote {argv[0]}")
    else:
        print(text)
    return 0


def _cli_report(argv) -> int:
    if not argv:
        print(
            "report: needs a records.jsonl path [policy.json]",
            file=sys.stderr,
        )
        return 2
    records_path = argv[0]
    policy = SLOPolicy.load(argv[1]) if len(argv) > 1 else default_policy()
    engine = SLOEngine(policy)
    last_ts = None
    try:
        with open(records_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                ts = rec.get("ts")
                if isinstance(ts, (int, float)):
                    last_ts = ts
                # Offline fold: the record's own wall-clock timestamp
                # is the event time, so burn windows replay correctly.
                engine.fold(rec, t=last_ts if last_ts is not None else 0.0)
    except OSError as e:
        print(f"{records_path}: FAIL — {e}", file=sys.stderr)
        return 1
    # The default sink is a no-op unless utils.metrics.configure named a
    # target: an offline report prints, it does not append to a ledger.
    report = engine.maybe_report(
        now=last_ts if last_ts is not None else 0.0, force=True
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def main(argv) -> int:
    if not argv:
        print(
            "usage: python -m ba_tpu_torch.obs.slo "
            "{validate <policy.json> ... | default [out.json] | "
            "report <records.jsonl> [policy.json]}",
            file=sys.stderr,
        )
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "validate":
        return _cli_validate(rest)
    if cmd == "default":
        return _cli_default(rest)
    if cmd == "report":
        return _cli_report(rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
