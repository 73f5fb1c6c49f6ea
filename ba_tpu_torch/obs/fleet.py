"""Fleet-scope stream aggregation (the port's copy of
``ba_tpu/obs/fleet.py``): merge per-process sink shards, align their
clocks, and rebuild each served request's causal tree.

The read side of the sharded sink (``utils.metrics.configure("dir/")``:
``utils/metrics.MetricsSink``'s directory mode): each process appended
``<pid>.<token>.jsonl`` with a ``clock_anchor`` first line; here the
shards merge into one deterministic stream and assemble into:

- :func:`assemble_request_trace`: a versioned ``request_trace`` record a
  served request, the whole cross-process span tree (client ->
  dispatcher -> coalesced batch -> engine dispatch / retire -> the sign
  pool workers' ``pool_task`` spans), the spans of other requests'
  traces grafted in through the dispatcher's ``fan_in`` edges, the
  critical path, and a per-phase attribution held against the SLO
  engine's invariant (``sum(PHASES) ~= wall_s`` within ``ATTRIB_TOL_S``).
- :class:`FleetSummary`: the per-replica / per-cohort rollup behind the
  REPL's ``stats --fleet`` line.

Clock alignment: a shard's anchor pairs one ``time.perf_counter()``
reading with one ``time.time()`` reading taken back to back at shard
open; ``offset = anchor.ts - anchor.perf_t`` maps that process's
monotonic clock onto the shared unix axis, so a record carrying
``t_perf`` aligns as ``t_perf + offset`` (records without one fall back
to their ``ts``).  Records sort by ``(aligned_t, shard_name,
line_index)``, a total order over static inputs, so two merges of one
directory are byte-identical (:func:`merge_digest`), and equal to the
JAX package's merge of the same shards.

The stdlib, ``utils.metrics`` and ``obs.slo`` only: ``python -m
ba_tpu_torch.obs.fleet <dir>`` loads neither torch nor numpy.  Reading
takes no lock and skips a torn tail (a killed writer's half line).
"""

from __future__ import annotations

import json
import os
import re

from ba_tpu_torch.obs.slo import ATTRIB_TOL_S, PHASES
from ba_tpu_torch.utils import metrics as _metrics

# The shard filename grammar: <pid>.<token>.jsonl, where
# token is the writer's active run id at shard open, else a random
# process token.  The filename is PROVENANCE only — merging always
# joins on the run_id/trace_id fields, never on names.
SHARD_RE = re.compile(r"^(\d+)\.(.+)\.jsonl$")


def list_shards(path: str) -> list:
    """Sorted ``(shard_name, shard_path)`` pairs under a sink dir."""
    out = []
    for name in sorted(os.listdir(path)):
        if SHARD_RE.match(name):
            out.append((name, os.path.join(path, name)))
    return out


def read_shard(path: str) -> list:
    """One shard's records, in file order.  Tolerates a torn tail and
    blank lines (a SIGKILL mid-write must not poison the merge) — like
    ``obs/flight``'s reader, malformed lines are skipped, not fatal."""
    records = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        pass
    return records


def shard_offset(records) -> float | None:
    """The shard's perf_counter->unix offset from its latest
    ``clock_anchor`` (the perf epoch is process-constant, so any anchor
    works; the latest is freshest against wall-clock steps)."""
    offset = None
    for rec in records:
        if rec.get("event") == "clock_anchor":
            perf_t, ts = rec.get("perf_t"), rec.get("ts")
            if isinstance(perf_t, (int, float)) and isinstance(
                ts, (int, float)
            ):
                offset = ts - perf_t
    return offset


def merge_shards(path: str) -> list:
    """Every shard's records on ONE aligned, deterministic axis.

    Each returned record is a copy annotated with ``shard`` (its
    source file) and ``t_align`` (its position on the shared unix
    axis: ``t_perf + offset`` when the record carries a perf stamp and
    the shard has an anchor, its coarse ``ts`` otherwise).  Order is
    ``(t_align, shard, line_index)`` — total, so re-merging the same
    directory is byte-identical.
    """
    merged = []
    for name, shard_path in list_shards(path):
        records = read_shard(shard_path)
        offset = shard_offset(records)
        for idx, rec in enumerate(records):
            t_perf = rec.get("t_perf")
            if isinstance(t_perf, (int, float)) and offset is not None:
                t_align = t_perf + offset
            else:
                ts = rec.get("ts")
                t_align = ts if isinstance(ts, (int, float)) else 0.0
            merged.append(
                (round(t_align, 6), name, idx,
                 dict(rec, shard=name, t_align=round(t_align, 6)))
            )
    merged.sort(key=lambda item: item[:3])
    return [item[3] for item in merged]


def merge_digest(records) -> str:
    """A canonical digest of a merged stream — two assembly runs over
    one shard directory must agree byte-for-byte (the bench's
    ``merge_deterministic`` check)."""
    import hashlib

    payload = json.dumps(
        records, sort_keys=True, separators=(",", ":")
    ).encode()
    return hashlib.sha256(payload).hexdigest()


# -- span trees ---------------------------------------------------------------


def _shard_pid(shard) -> int | None:
    m = SHARD_RE.match(shard or "")
    return int(m.group(1)) if m else None


def _node(rec) -> dict:
    return {
        "span_id": rec["span_id"],
        "parent_id": rec.get("parent_id"),
        "name": rec.get("name") or rec.get("event") or "?",
        "events": [],
        "shard": rec.get("shard"),
        "pid": _shard_pid(rec.get("shard")),
        "t_align": rec.get("t_align"),
        "dur_s": None,
    }


def _fold(node, rec) -> None:
    node["events"].append(rec.get("event") or "?")
    if node["parent_id"] is None and rec.get("parent_id") is not None:
        node["parent_id"] = rec["parent_id"]
    if rec.get("event") == "trace_span" and rec.get("name"):
        node["name"] = rec["name"]  # the explicit node record names it
    dur = rec.get("dur_s")
    if dur is None:
        dur = rec.get("latency_s")  # flight_span's span duration
    if isinstance(dur, (int, float)):
        node["dur_s"] = round(
            max(node["dur_s"] or 0.0, float(dur)), 6
        )


def span_nodes(records) -> dict:
    """Span-id -> node, merging every record that carries the span
    (events-on-span: a request record and its retries land on ONE
    node).  ``records`` should already be merged/aligned."""
    nodes: dict = {}
    for rec in records:
        sid = rec.get("span_id")
        if not isinstance(sid, str):
            continue
        node = nodes.get(sid)
        if node is None:
            node = nodes[sid] = _node(rec)
        _fold(node, rec)
    return nodes


def _descendants(nodes, root_sid) -> set:
    children: dict = {}
    for sid, node in nodes.items():
        children.setdefault(node["parent_id"], []).append(sid)
    out, frontier = set(), [root_sid]
    while frontier:
        sid = frontier.pop()
        if sid in out:
            continue
        out.add(sid)
        frontier.extend(children.get(sid, ()))
    return out


def assemble_request_trace(records, request_id=None) -> dict | None:
    """One served request's cross-process span tree as a versioned
    ``request_trace`` record (None when no traced request matches).

    Tree membership: the spans of the request's own trace whose parent
    chain tops out at THIS request's root (coalesced members can share
    one trace id — an external caller injecting the same traceparent
    into every request — so a sibling request's subtree in the same
    trace is excluded by ownership, not by trace id), plus — through
    the dispatcher's coalesced-batch ``fan_in`` edges — the shared
    batch subtree owned by a different member, reparented under this
    request's root (one request -> one tree, even though the engine
    work was shared).  A same-trace span whose chain dies at an
    UNKNOWN parent stays in (and shows up in ``unparented``): orphans
    are breakage to surface, never to filter away.  ``unparented``
    lists the non-root spans whose parent resolves to no known span —
    the kill-mid-request test and the bench pin it empty.

    The critical path is the request's own five-phase decomposition
    (queue -> coalesce -> compile -> dispatch -> retire), and
    ``within_tol`` holds its sum to the SLO engine's invariant:
    ``|sum(PHASES) - wall_s| <= ATTRIB_TOL_S``.
    """
    req = None
    for rec in records:
        if rec.get("event") != "request" or "trace_id" not in rec:
            continue
        if request_id is not None and rec.get("id") != request_id:
            continue
        req = rec  # last wins: the freshest terminal record
    if req is None:
        return None
    trace_id, root_sid = req["trace_id"], req.get("span_id")

    own = [r for r in records if r.get("trace_id") == trace_id]
    all_nodes = span_nodes(own)
    sibling_roots = {
        r.get("span_id")
        for r in own
        if r.get("event") == "request" and r.get("span_id") != root_sid
    }

    def _chain_top(sid):
        # The top of a span's parent chain within this trace: our root,
        # a sibling request's root, or (orphan) the first span whose
        # parent is unknown.  Cycle-guarded — corrupt data stays IN so
        # the unparented audit can flag it.
        seen = set()
        while sid not in seen:
            seen.add(sid)
            node = all_nodes.get(sid)
            parent = node["parent_id"] if node else None
            if parent is None or parent not in all_nodes:
                return sid
            sid = parent
        return sid

    nodes = {
        sid: node
        for sid, node in all_nodes.items()
        if _chain_top(sid) not in sibling_roots
    }
    # Fan-in grafts: a batch span that names our root but is not
    # already ours by ownership (another member's trace, or a sibling-
    # owned batch inside a SHARED trace) adopts our root as parent, and
    # brings its whole subtree (window spans, sign stage, pool workers)
    # along.
    for rec in records:
        if rec.get("event") != "trace_span":
            continue
        if rec.get("span_id") in nodes:
            continue
        fan_in = rec.get("fan_in") or []
        if root_sid not in fan_in:
            continue
        foreign = [
            r for r in records if r.get("trace_id") == rec.get("trace_id")
        ]
        foreign_nodes = span_nodes(foreign)
        keep = _descendants(foreign_nodes, rec["span_id"])
        for sid in keep:
            node = dict(foreign_nodes[sid])
            if sid == rec["span_id"]:
                node["parent_id"] = root_sid
                node["fan_in"] = sorted(fan_in)
            nodes.setdefault(sid, node)

    known = set(nodes)
    unparented = sorted(
        sid
        for sid, node in nodes.items()
        if sid != root_sid
        and (node["parent_id"] is None or node["parent_id"] not in known)
    )
    spans = [
        nodes[sid]
        for sid in sorted(
            nodes, key=lambda s: (nodes[s]["t_align"] or 0.0, s)
        )
    ]

    hops = [
        {"hop": name, "s": round(float(req[name]), 6)}
        for name in PHASES
        if isinstance(req.get(name), (int, float))
    ]
    attribution_s = round(sum(h["s"] for h in hops), 6)
    wall_s = req.get("wall_s")
    within_tol = (
        len(hops) == len(PHASES)
        and isinstance(wall_s, (int, float))
        and abs(attribution_s - wall_s) <= ATTRIB_TOL_S
    )
    return {
        "event": "request_trace",
        "v": _metrics.SCHEMA_VERSION,
        "trace_id": trace_id,
        "request_id": req.get("id"),
        "run_id": req.get("run_id"),
        "root_span": root_sid,
        "spans": spans,
        "span_count": len(spans),
        "processes": sorted(
            {n["pid"] for n in spans if n["pid"] is not None}
        ),
        "unparented": unparented,
        "critical_path": hops,
        "attribution_s": attribution_s,
        "wall_s": wall_s,
        "within_tol": within_tol,
    }


def request_ids(records) -> list:
    """Every traced request id in the merged stream, in stream order."""
    out, seen = [], set()
    for rec in records:
        if rec.get("event") == "request" and "trace_id" in rec:
            rid = rec.get("id")
            if rid not in seen:
                seen.add(rid)
                out.append(rid)
    return out


# -- fleet rollup -------------------------------------------------------------


def _quantile(sorted_vals, q) -> float | None:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(len(sorted_vals) * q))
    return round(sorted_vals[idx], 6)


class FleetSummary:
    """Fold a merged stream into the per-replica / per-cohort rollup.

    A replica is one writer process (keyed by its shard — the unit the
    elastic-fleet router scales); cohorts use the SAME cohort label the
    serve tier stamps on ``request`` records (the key the router joins
    against ``autoscale_signal``).  Lock-free by construction: folding
    reads an already-merged list; the REPL's ``stats --fleet`` line
    re-merges on demand and never touches writer state.
    """

    def __init__(self):
        self.replicas: dict = {}
        self.cohorts: dict = {}
        self.pool_tasks = 0
        self.traces: set = set()
        self.worst_burn = None
        self.slo_alerts = 0
        self.autoscale_last = None

    def add(self, rec) -> None:
        event = rec.get("event")
        shard = rec.get("shard") or "?"
        rep = self.replicas.get(shard)
        if rep is None:
            rep = self.replicas[shard] = {
                "shard": shard,
                "pid": _shard_pid(shard),
                "records": 0,
                "requests": 0,
                "ok": 0,
                "pool_tasks": 0,
                "walls": [],
            }
        rep["records"] += 1
        if isinstance(rec.get("trace_id"), str):
            self.traces.add(rec["trace_id"])
        if event == "pool_task":
            rep["pool_tasks"] += 1
            self.pool_tasks += 1
        elif event == "slo_alert":
            self.slo_alerts += 1
        elif event == "autoscale_signal":
            self.autoscale_last = {
                "replicas": rec.get("replicas"),
                "recommended": rec.get("recommended"),
                "reason": rec.get("reason"),
            }
        elif event == "slo_report":
            burn = rec.get("worst_burn")
            if isinstance(burn, (int, float)) and (
                self.worst_burn is None or burn > self.worst_burn
            ):
                self.worst_burn = burn
        elif event == "request":
            rep["requests"] += 1
            status = rec.get("status")
            cohort = rec.get("cohort") or "?"
            grp = self.cohorts.get(cohort)
            if grp is None:
                grp = self.cohorts[cohort] = {
                    "cohort": cohort,
                    "requests": 0,
                    "counts": {},
                    "tenants": set(),
                    "walls": [],
                }
            grp["requests"] += 1
            grp["counts"][status] = grp["counts"].get(status, 0) + 1
            if rec.get("tenant"):
                grp["tenants"].add(rec["tenant"])
            wall = rec.get("wall_s")
            if status == "ok" and isinstance(wall, (int, float)):
                rep["ok"] += 1
                rep["walls"].append(float(wall))
                grp["walls"].append(float(wall))

    def record(self) -> dict:
        """The versioned ``fleet_summary`` record (the router-facing
        contract)."""
        replicas = []
        for shard in sorted(self.replicas):
            rep = dict(self.replicas[shard])
            walls = sorted(rep.pop("walls"))
            rep["wall_p50_s"] = _quantile(walls, 0.5)
            rep["wall_p99_s"] = _quantile(walls, 0.99)
            replicas.append(rep)
        cohorts = []
        for label in sorted(self.cohorts):
            grp = dict(self.cohorts[label])
            walls = sorted(grp.pop("walls"))
            grp["tenants"] = len(grp["tenants"])
            grp["wall_p50_s"] = _quantile(walls, 0.5)
            grp["wall_p99_s"] = _quantile(walls, 0.99)
            cohorts.append(grp)
        return {
            "event": "fleet_summary",
            "v": _metrics.SCHEMA_VERSION,
            "replicas": replicas,
            "cohorts": cohorts,
            "requests": sum(g["requests"] for g in cohorts),
            "pool_tasks": self.pool_tasks,
            "traces": len(self.traces),
            "worst_burn": self.worst_burn,
            "slo_alerts": self.slo_alerts,
            "autoscale_last": self.autoscale_last,
        }


def fleet_summary(records) -> dict:
    """Fold an already-merged stream into one ``fleet_summary`` record."""
    acc = FleetSummary()
    for rec in records:
        acc.add(rec)
    return acc.record()


def summary_line(summary: dict) -> str:
    """The one-line ``stats --fleet`` rendering of a summary record."""
    walls = [
        r["wall_p99_s"]
        for r in summary.get("replicas", [])
        if r.get("wall_p99_s") is not None
    ]
    p99 = max(walls) if walls else None
    burn = summary.get("worst_burn")
    return (
        f"fleet replicas={len(summary.get('replicas', []))} "
        f"cohorts={len(summary.get('cohorts', []))} "
        f"requests={summary.get('requests')} "
        f"pool_tasks={summary.get('pool_tasks')} "
        f"traces={summary.get('traces')} "
        f"p99_s={p99 if p99 is not None else '-'} "
        f"worst_burn={burn if burn is not None else '-'}"
    )


def assemble_fleet(path: str) -> dict:
    """Merge a sink directory and assemble everything: the summary, one
    ``request_trace`` per traced request, and the determinism digest."""
    records = merge_shards(path)
    traces = [
        assemble_request_trace(records, request_id=rid)
        for rid in request_ids(records)
    ]
    return {
        "records": len(records),
        "shards": [name for name, _ in list_shards(path)],
        "digest": merge_digest(records),
        "summary": fleet_summary(records),
        "request_traces": [t for t in traces if t is not None],
    }


def _main(argv) -> int:
    """``python -m ba_tpu_torch.obs.fleet DIR``: merge twice (pinning
    byte-identity), assemble every request trace, and fail on any
    unparented span or broken attribution."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.split("\n\n")[0])
        print("usage: python -m ba_tpu_torch.obs.fleet SINK_DIR")
        return 2
    path = argv[0]
    first = merge_shards(path)
    second = merge_shards(path)
    deterministic = merge_digest(first) == merge_digest(second)
    assembled = assemble_fleet(path)
    bad = [
        t for t in assembled["request_traces"]
        if t["unparented"] or not t["within_tol"]
    ]
    print(
        json.dumps(
            {
                "shards": len(assembled["shards"]),
                "records": assembled["records"],
                "request_traces": len(assembled["request_traces"]),
                "merge_deterministic": deterministic,
                "all_spans_parented": not any(
                    t["unparented"] for t in assembled["request_traces"]
                ),
                "critical_path_within_tol": all(
                    t["within_tol"] for t in assembled["request_traces"]
                ),
                "digest": assembled["digest"],
            }
        )
    )
    if not deterministic or bad or not assembled["request_traces"]:
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
