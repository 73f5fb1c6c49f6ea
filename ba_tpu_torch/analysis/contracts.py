"""The port's contract registry (``ba_tpu/analysis/contracts.py``):
record families, the schema version, the run-scoped set, the metric-name
rule and the documented environment.

- :data:`RECORD_FAMILIES`: every versioned ``{"event": ..., "v": N}``
  JSONL family the port emits (``utils.metrics.emit`` sites such as
  ``runtime/warmup.py``'s ``warmup``, ``runtime/supervisor.py``'s
  ``recovery``, ``runtime/chaos.py``'s ``fault_injected`` and
  ``runtime/serve.py``'s ``admission``), with the keys each emit site
  must spell literally and whether the sink's run scope stamps it.
  BA601 checks every emit site it can read statically against it.  The
  port emits the reference's 35 families under the reference's names.
- :data:`SCHEMA_VERSION`: the records' ``"v"``; a test pins it equal to
  ``ba_tpu_torch/utils/metrics.py``'s.
- :data:`RUN_SCOPED_EVENTS`: the families that always carry ``run_id``;
  a test pins it equal to ``ba_tpu_torch/obs/flight.py``'s set and to
  the reference's.
- :func:`metric_name_violation`: the ``serve_`` prefix and
  ``_per_shard`` suffix rules that ``obs/registry.MetricsRegistry``
  asserts at run time and BA602 checks at every construction site.
- :data:`ENV_DOCUMENTED`: empty.  Departure from the reference: the
  port reads no environment (its knobs are keywords), so BA603 flags
  every read rather than the undocumented ones.

Standard library only, like the rest of the analyzer.
"""

from __future__ import annotations

# The records' schema version ("v"; utils/metrics.SCHEMA_VERSION).
SCHEMA_VERSION = 1


def _family(required=(), run_scoped=False):
    return {"required": tuple(required), "run_scoped": run_scoped}


# Every record family the port emits.  ``required`` lists the keys an
# emit site must spell as literal dict keys (``run_id`` only for
# families whose emitters stamp it themselves: the others rely on the
# sink's run scope, which ``run_scoped`` marks).
RECORD_FAMILIES = {
    "agreement_round": _family(
        ("round", "n", "leader_id", "order", "decision")
    ),
    "pipeline_dispatch": _family(
        ("dispatch", "round_base", "n", "order")
    ),
    "agreement_rounds_pipelined": _family(
        ("rounds", "dispatches", "depth", "decision_counts")
    ),
    "scenario_campaign": _family(("name", "rounds", "dispatches")),
    "search_campaign": _family(
        ("objective", "generations", "campaigns", "found")
    ),
    "metrics_snapshot": _family(("metrics",)),
    "compiled_artifact": _family(("fn", "axes", "flops", "bytes_accessed")),
    "recompile": _family(("fn", "axes", "changed", "cross_process")),
    "scenario_checkpoint": _family(
        ("scenario", "round", "rounds", "path", "bytes"), run_scoped=True
    ),
    "recovery": _family(
        ("action", "attempt", "fault", "error", "from_round", "lost_rounds"),
        run_scoped=True,
    ),
    "fault_injected": _family(
        ("kind", "phase", "round", "plan"), run_scoped=True
    ),
    "flight_span": _family(
        ("dispatch", "phase", "lo", "hi", "latency_s", "lag_s"),
        run_scoped=True,
    ),
    "health_snapshot": _family((), run_scoped=True),
    "flight_summary": _family(
        ("run_id", "rounds", "windows", "timeline"), run_scoped=True
    ),
    "request": _family(
        ("id", "kind", "status", "cohort", "tenant", "wall_s")
    ),
    "admission": _family(("decision", "tier", "queue_depth")),
    "shed": _family(("tier", "prev_tier", "queue_depth")),
    "warmup": _family(("phase", "run_id")),
    "sign_ahead": _family(("lo", "hi", "batch", "wall_s")),
    "sign_pool": _family(
        ("run_id", "workers", "requested", "degraded", "rounds"),
        run_scoped=True,
    ),
    "search_generation": _family(
        ("generation", "campaigns", "new_found", "found_total",
         "best_score", "objective"),
        run_scoped=True,
    ),
    "search_found": _family(
        ("generation", "uid", "name", "score", "objective"), run_scoped=True
    ),
    "search_minimized": _family(
        ("generation", "uid", "name", "bit_exact"), run_scoped=True
    ),
    "search_checkpoint": _family(
        ("generation", "path", "found"), run_scoped=True
    ),
    "slo_report": _family(
        ("run_id", "groups", "objectives", "worst_burn"), run_scoped=True
    ),
    "slo_alert": _family(
        ("run_id", "objective", "state", "burn_fast", "burn_slow"),
        run_scoped=True,
    ),
    "autoscale_signal": _family(
        ("run_id", "recommended", "replicas", "burn", "queue_frac"),
        run_scoped=True,
    ),
    "clock_anchor": _family(("pid", "shard", "perf_t", "ts")),
    "trace_span": _family(
        ("name", "trace_id", "span_id", "parent_id", "t_perf", "dur_s"),
    ),
    "pool_task": _family(("kind", "rows", "wall_s", "t_perf")),
    "request_trace": _family(
        ("trace_id", "request_id", "root_span", "spans", "span_count",
         "processes", "unparented", "critical_path", "attribution_s",
         "wall_s", "within_tol"),
    ),
    "fleet_summary": _family(
        ("replicas", "cohorts", "requests", "pool_tasks", "traces",
         "worst_burn", "slo_alerts", "autoscale_last"),
    ),
    "router_route": _family(
        ("request_id", "cohort", "replica", "hops", "rerouted"),
    ),
    "replica_state": _family(("replica", "state", "prev")),
    "migration": _family(("phase", "campaign", "from_replica")),
}

# The families that by construction always carry ``run_id``
# (obs/flight.RUN_SCOPED_EVENTS; a test pins the two equal).
RUN_SCOPED_EVENTS = frozenset(
    name for name, spec in RECORD_FAMILIES.items() if spec["run_scoped"]
)


def metric_name_violation(name: str):
    """The instrument-naming contract, as one predicate: a reason
    string, or ``None`` when the name conforms.  The same rule
    ``obs/registry.MetricsRegistry`` asserts at run time."""
    if "per_shard" in name and not name.endswith("_per_shard"):
        return (
            f"per-shard metric {name!r} must end with '_per_shard' "
            f"(the suffix is the shard-denominator marker dashboards "
            f"key on)"
        )
    if "serve" in name.split("_") and not name.startswith("serve_"):
        return (
            f"service metric {name!r} must start with 'serve_' "
            f"(the prefix rule groups the serving family in "
            f"dashboards)"
        )
    return None


# The documented environment: none.  The port's knobs are keywords
# (``pipeline_sweep(run_id=)``, ``ServeConfig(...)``), so any read is a
# finding (BA603).
ENV_DOCUMENTED = frozenset()
